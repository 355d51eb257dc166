"""The port's numpy constant builders agree bit for bit with the reference's."""
import numpy as np
import pytest

from repro.core import constants as ref_c
from repro.core import so3 as ref_so3
from repro_torch.core import constants as port_c
from repro_torch.core import so3 as port_so3

BUILDERS = [
    ("y_dense", (1,)), ("y_dense", (3,)),
    ("z_dense", (4, 2)), ("z_dense", (6, 3)),
    ("y_half", (2,)), ("y_half", (3, "complex128")),
    ("z_half", (4, 2)), ("z_half", (6, 2)),
    ("filter_fourier_col", (3,)),
    ("conv_u_index", (2, 3)),
    ("cg_11_blocks", (2,)), ("cg_11_blocks", (4,)),
    ("chain_sample_sh", (2, 6)),
    ("chain_sample_grid", (2, 6)), ("chain_sample_grid", (1, 2)),
    ("chain_project_sh", (6, 2)), ("chain_project_sh", (4, 4)),
    ("chain_project_grid", (3,)),
    ("chain_matrices", ((2, 2, 2), 2)),
    ("chain_matrices", ((2, 1, 2), 3, ("grid", "sh", "sh"), "sh", False)),
    ("chain_matrices", ((1, 1), 2, ("sh", "sh"), "grid", True, "float64")),
    ("chain_l0", ((2, 2, 2),)),
    ("chain_l0", ((1, 2), ("sh", "grid"))),
]


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name,args", BUILDERS, ids=lambda v: str(v))
def test_builder_bitwise_equal(name, args):
    assert _equal(getattr(port_c, name)(*args), getattr(ref_c, name)(*args))


@pytest.mark.parametrize("L", [0, 2, 5])
def test_real_sph_harm_bitwise_equal(L):
    xyz = np.random.default_rng(L).normal(size=(17, 3))
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    assert np.array_equal(port_so3.real_sph_harm(L, xyz), ref_so3.real_sph_harm(L, xyz))


def test_to_torch_caches_one_tensor_per_device():
    import torch

    y = port_c.y_half(2)
    a = port_c.to_torch(y, "cpu")
    assert a is port_c.to_torch(y, "cpu")
    assert a.dtype == torch.complex64 and np.array_equal(a.numpy(), y)
    assert port_c.to_torch(port_c.filter_fourier_col(2), "cpu", torch.complex128).dtype \
        == torch.complex128


@pytest.mark.parametrize("L", [2, 6])
def test_z_half_l0_is_the_l0_row(L):
    got = port_c.z_half_l0(L)
    assert got is port_c.z_half_l0(L)
    assert _equal(got, np.ascontiguousarray(ref_c.z_half(L, 0)[:, :, 0]))


def test_gated_fourier_exit_adds_no_cache_entry_per_call():
    import torch
    from repro_torch.core.engine import _gate_rep
    from repro_torch.core.rep import Rep

    rng = np.random.default_rng(0)
    rep = Rep.from_sh(torch.as_tensor(rng.normal(size=(5, 4, 9)), dtype=torch.float32),
                      2).to_fourier("half")
    gp = {"w1": torch.as_tensor(rng.normal(size=(4, 8)), dtype=torch.float32),
          "w2": torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32)}
    _gate_rep(gp, rep)
    n = len(port_c._TORCH)
    for _ in range(3):
        _gate_rep(gp, rep)
    assert len(port_c._TORCH) == n
