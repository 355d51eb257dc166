"""The port's batched plans (`engine.plan_batch`) — twins of the unsharded
plan_batch tests of tests/test_engine_transforms.py — and the port's
buckets against the reference's on the same numpy inputs.

Each bucket is one call on its inner plan over the concatenated,
tail-padded rows, so its outputs equal per-plan calls (1e-6, as the
reference's tests hold them).  The reference comparison runs at the f32
identity tier, ``repro.testing.tol_for('float32')``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.testing import assert_close, random_array, random_irreps, random_unit_vectors
from repro_torch.core import engine
from repro_torch.core.irreps import num_coeffs

PAIRWISE = engine.available_backends("pairwise", requires_grad=False)
CONV = engine.available_backends("conv_filter", requires_grad=False)
RAGGED = [(2, 2, 4, 7), (1, 1, 2, 4), (2, 2, 4, 3), (3, 2, 3, 5)]
# the port's backend names -> the reference's
REF_NAME = {"fused_torch": "fused_xla", "fused_hopper": "fused_pallas"}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, tol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _plan(*a, **kw):
    return engine.plan(*a, device="cpu", requires_grad=kw.pop("requires_grad", False), **kw)


@pytest.mark.parametrize("backend", PAIRWISE)
def test_plan_batch_matches_per_plan_loop(backend):
    bp = engine.plan_batch(RAGGED, backend=backend, requires_grad=False, device="cpu")
    ins = [(_t(random_irreps(L1, (n,), seed=i)), _t(random_irreps(L2, (n,), seed=50 + i)))
           for i, (L1, L2, Lout, n) in enumerate(RAGGED)]
    outs = bp.apply(ins)
    assert len(bp.buckets) == 3
    for (L1, L2, Lout, n), (x1, x2), got in zip(RAGGED, ins, outs):
        assert got.shape == (n, num_coeffs(Lout))
        _close(got, _plan(L1, L2, Lout, backend=backend).apply(x1, x2))


@pytest.mark.parametrize("backend", PAIRWISE)
def test_plan_batch_weights_match_per_plan(backend):
    items = [(2, 3, 4, 5), (2, 3, 4, 2)]
    bp = engine.plan_batch(items, backend=backend, requires_grad=False, device="cpu")
    ins, ws = [], []
    for i, (L1, L2, Lout, n) in enumerate(items):
        ins.append((_t(random_irreps(L1, (n,), seed=i)),
                    _t(random_irreps(L2, (n,), seed=20 + i))))
        ws.append((_t(random_array((n, L1 + 1), seed=30 + i)), None,
                   _t(random_array((n, Lout + 1), seed=40 + i))))
    ws[1] = None  # the second item unweighted: the ones-fill path
    outs = bp.apply(ins, weights=ws)
    p = _plan(2, 3, 4, backend=backend)
    _close(outs[0], p.apply(*ins[0], ws[0][0], None, ws[0][2]))
    _close(outs[1], p.apply(*ins[1]))


@pytest.mark.parametrize("backend", CONV)
def test_plan_batch_conv_filter_matches_per_plan(backend):
    bp = engine.plan_batch([(2, 2, 3, 6)], kind="conv_filter", backend=backend,
                           requires_grad=False, pad_to=8, device="cpu")  # 2 pad rows
    x = _t(random_irreps(2, (6,), seed=70))
    r = _t(random_unit_vectors((6,), seed=71))
    got = bp.apply([(x, r)])[0]
    _close(got, _plan(2, 2, 3, kind="conv_filter", backend=backend).apply(x, r), 1e-5)
    assert bool(torch.isfinite(got).all())  # e_z padding keeps escn NaN-free


def test_plan_batch_broadcast_inner_dims():
    """One direction per edge against C channel features (the MACE layout)."""
    n, C = 4, 5
    x = _t(random_irreps(2, (n, n, C), seed=80))
    r = _t(random_unit_vectors((n, n, 1), seed=81))
    bp = engine.plan_batch([(2, 2, 2)], kind="conv_filter", backend="escn_aligned",
                           device="cpu")
    got = bp.apply([(x, r)])[0]
    assert got.shape == (n, n, C, num_coeffs(2))
    _close(got, _plan(2, 2, 2, kind="conv_filter", backend="escn_aligned",
                      requires_grad=True).apply(x, r), 1e-5)


def test_plan_batch_weight_broadened_output():
    """Weights with leading dims beyond the operands' broadcast shape widen
    the output: the bucket degrades to the backend's own broadcasting."""
    x = _t(random_irreps(2, (), seed=120))
    r = _t(random_unit_vectors((), seed=121))
    w1 = _t(random_array((5, 3), seed=122))
    bp = engine.plan_batch([(2, 2, 2)], kind="conv_filter", backend="escn_aligned",
                           device="cpu")
    got = bp.apply([(x, r)], weights=[(w1, None, None)])[0]
    ref = _plan(2, 2, 2, kind="conv_filter", backend="escn_aligned",
                requires_grad=True).apply(x, r, w1)
    assert got.shape == ref.shape == (5, num_coeffs(2))
    _close(got, ref, 1e-5)


def test_plan_batch_grad_matches_per_plan():
    bp = engine.plan_batch([(2, 2, 4, 6)], device="cpu")
    p = _plan(2, 2, 4, requires_grad=True)
    x2 = _t(random_irreps(2, (6,), seed=91))
    grads = []
    for f in (lambda a: bp.apply([(a, x2)])[0], lambda a: p.apply(a, x2)):
        a = _t(random_irreps(2, (6,), seed=90)).requires_grad_(True)
        (f(a) ** 2).sum().backward()
        grads.append(a.grad)
    _close(grads[0], grads[1].numpy(), 1e-5)


def test_plan_batch_bucketing_and_cache():
    items = [(2, 2, 4, 4), (1, 1, 2, 4), (2, 2, 4, 9)]
    bp1 = engine.plan_batch(items, requires_grad=False, device="cpu")
    assert len(bp1.buckets) == 2
    assert {tuple(sorted(b.item_ids)) for b in bp1.buckets} == {(0, 2), (1,)}
    assert bp1.buckets[0].plan.key.batch_hint == 13  # the bucket's size hints summed
    assert engine.plan_batch(items, requires_grad=False, device="cpu") is bp1
    assert "plan_batch" in bp1.describe()


def test_plan_batch_donate_flag_plumbing():
    """donate=True is accepted and donates nothing: the caller's operands
    are read, never written or released."""
    bp = engine.plan_batch([(2, 2, 4, 4)], donate=True, requires_grad=False, device="cpu")
    assert bp.donate
    x1 = _t(random_irreps(2, (4,), seed=110))
    x2 = _t(random_irreps(2, (4,), seed=111))
    keep = x1.clone()
    out = bp.apply([(x1, x2)])[0]
    assert out.shape == (4, num_coeffs(4)) and torch.equal(x1, keep)


def test_plan_batch_rejects_channel_mix_and_bad_items():
    with pytest.raises(ValueError):
        engine.plan_batch([(1, 1, 2)], kind="channel_mix", device="cpu")
    with pytest.raises(ValueError):
        engine.plan_batch([], device="cpu")
    with pytest.raises(ValueError):
        engine.plan_batch([(1, 1)], device="cpu")
    # manybody items are ported: each needs Ls with >= 2 degrees, as in the
    # reference, and a bucket of them equals the reference's
    with pytest.raises(ValueError, match="Ls"):
        engine.plan_batch([engine.BatchItem(Ls=(2,))], kind="manybody", device="cpu")
    xs = [random_irreps(2, (5,), seed=60 + i) for i in range(2)]
    bp = engine.plan_batch([engine.BatchItem(Ls=(2, 2))], kind="manybody",
                           backend="direct", device="cpu")
    want = ref_engine.plan_batch([ref_engine.BatchItem(Ls=(2, 2))], kind="manybody",
                                 backend="direct").apply([[jnp.asarray(x) for x in xs]])[0]
    assert_close(bp.apply([[_t(x) for x in xs]])[0].numpy(), np.asarray(want),
                 dtype="float32")
    with pytest.raises(ValueError, match="shard mode"):
        engine.plan_batch([(1, 1, 2)], shard_spec=engine.ShardSpec(mode="nope"), device="cpu")
    # with no mesh the spec is inert: one rank, the rows' own granularity
    inert = engine.plan_batch([engine.BatchItem(Ls=(2, 2))], kind="manybody",
                              backend="direct", shard_spec=engine.ShardSpec(), device="cpu")
    assert inert.granularity == 1
    assert_close(inert.apply([[_t(x) for x in xs]])[0].numpy(), np.asarray(want),
                 dtype="float32")


@pytest.mark.parametrize("backend", ["direct", "rfft", "fused_torch"])
def test_plan_batch_matches_reference_buckets(backend):
    """The port's buckets against the reference's plan_batch on the same
    inputs, weights and padding."""
    items = [(2, 2, 4, 5), (1, 2, 3, 3), (2, 2, 4, 2)]
    ins = [(random_irreps(L1, (n,), seed=i), random_irreps(L2, (n,), seed=60 + i))
           for i, (L1, L2, Lout, n) in enumerate(items)]
    ws = [(random_array((n, L1 + 1), seed=70 + i), None, random_array((n, Lout + 1), seed=80 + i))
          for i, (L1, L2, Lout, n) in enumerate(items)]
    ref = ref_engine.plan_batch(items, backend=REF_NAME.get(backend, backend),
                                requires_grad=False, pad_to=4)
    want = ref.apply([tuple(jnp.asarray(a) for a in o) for o in ins],
                     weights=[tuple(None if w is None else jnp.asarray(w) for w in ww)
                              for ww in ws])
    bp = engine.plan_batch(items, backend=backend, requires_grad=False, pad_to=4,
                           device="cpu")
    got = bp.apply([tuple(_t(a) for a in o) for o in ins],
                   weights=[tuple(None if w is None else _t(w) for w in ww) for ww in ws])
    assert [b.item_ids for b in bp.buckets] == [b.item_ids for b in ref.buckets]
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w), dtype="float32")


def test_plan_batch_auto_dtype_resolves_per_bucket():
    """dtype='auto' flows through to each bucket's plan: float32 under
    heuristic tuning, the measured storage dtype under 'measure'."""
    eng = engine.GauntEngine()
    bp = eng.plan_batch([(1, 1, 2, 8), (2, 2, 2, 8)], dtype="auto", device="cpu")
    assert {b.plan.key.dtype for b in bp.buckets} == {"float32"} and eng.timing_runs == 0
    bm = eng.plan_batch([(1, 1, 2, 64)], dtype="auto", tune="measure",
                        requires_grad=False, device="cpu")
    auto_key = engine.PlanKey(1, 1, 2, "pairwise", 64, "auto", (), "cpu")
    assert bm.buckets[0].plan.key.dtype == eng.measured_pick(auto_key)
