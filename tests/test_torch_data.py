"""The port's numpy datasets against the reference's `repro.data`: the same
seed gives the same arrays, bit for bit; and the LM token pipeline's
resume and host sharding (the reference's `test_training_substrate.py`
pipeline tests)."""
import numpy as np
import pytest

from repro.data import LMTokenPipeline as RefPipeline
from repro.data import lj_dataset as ref_lj
from repro.data import nbody_dataset as ref_nbody
from repro_torch.data import LMTokenPipeline, lj_dataset, nbody_dataset


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n_atoms", [6, 8])
def test_lj_dataset_bit_equal(n_atoms):
    _same(lj_dataset(5, n_atoms=n_atoms, n_species=4, seed=3),
          ref_lj(5, n_atoms=n_atoms, n_species=4, seed=3))


def test_nbody_dataset_bit_equal():
    _same(nbody_dataset(3, n_particles=5, horizon=40, seed=2),
          ref_nbody(3, n_particles=5, horizon=40, seed=2))


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (4, 2)])
def test_pipeline_bit_equal(n_hosts, host_id):
    kw = dict(vocab=64, seq_len=16, global_batch=8, seed=5, host_id=host_id, n_hosts=n_hosts)
    p, r = LMTokenPipeline(**kw), RefPipeline(**kw)
    for _ in range(3):
        _same(p.next_batch(), r.next_batch())
    assert p.state() == r.state()


@pytest.mark.parametrize("step,n_hosts", [(0, 1), (7, 2), (23, 4)])
def test_pipeline_deterministic_resume(step, n_hosts):
    p1 = LMTokenPipeline(vocab=64, seq_len=16, global_batch=8, seed=3, n_hosts=n_hosts)
    for _ in range(step):
        p1.next_batch()
    want = p1.next_batch()
    p2 = LMTokenPipeline(vocab=64, seq_len=16, global_batch=8, seed=3, n_hosts=n_hosts)
    p2.restore({"step": step, "seed": 3})
    np.testing.assert_array_equal(want["tokens"], p2.next_batch()["tokens"])


def test_pipeline_host_sharding_partitions_batch():
    full = LMTokenPipeline(vocab=64, seq_len=8, global_batch=8, seed=5).next_batch()
    parts = [LMTokenPipeline(vocab=64, seq_len=8, global_batch=8, seed=5, host_id=h,
                             n_hosts=4).next_batch()["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), full["tokens"])


def test_pipeline_rejects_uneven_host_split():
    with pytest.raises(ValueError, match="does not split"):
        LMTokenPipeline(vocab=64, seq_len=8, global_batch=6, n_hosts=4)
