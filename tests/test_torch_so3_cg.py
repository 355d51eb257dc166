"""The port's SO(3) and CG pieces against the reference: the exact real
Gaunt tensor, the packed conversion builders, the pairwise collocation
matrices and the Wigner-D matrices bit for bit; the torch real spherical
harmonics against the JAX twin; the O(L^6) CG baseline; and the
equivariance of the port's pairwise product under `wigner_D_real_packed`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as ref_const
from repro.core import so3 as ref_so3
from repro.core.cg import cg_full_tensor_product as ref_cg
from repro.kernels.gaunt_fused import gaunt_fused_matrices as ref_fused_matrices
from repro.testing import assert_close
from repro_torch.core import constants as port_const
from repro_torch.core import engine as port_engine
from repro_torch.core import so3 as port_so3
from repro_torch.core.cg import cg_full_tensor_product, gaunt_dense_tensor
from repro_torch.kernels.gaunt_fused import gaunt_fused_matrices


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("L1,L2,L3", [(1, 1, 2), (2, 3, 4), (4, 4, 8), (3, 2, 1), (6, 6, 6)])
def test_real_gaunt_tensor_bit_for_bit(L1, L2, L3):
    _same(port_so3.real_gaunt_tensor(L1, L2, L3), ref_so3.real_gaunt_tensor(L1, L2, L3))
    _same(port_const.gaunt_dense(L1, L2, L3), ref_const.gaunt_dense(L1, L2, L3))
    _same(port_const.gaunt_dense(L1, L2, L3, "float64"),
          ref_const.gaunt_dense(L1, L2, L3, "float64"))
    _same(gaunt_dense_tensor(L1, L2, L3), ref_const.gaunt_dense(L1, L2, L3))


@pytest.mark.parametrize("L", [0, 1, 2, 4, 6])
def test_packed_builders_bit_for_bit(L):
    for a, b in zip(port_const.y_packed(L), ref_const.y_packed(L)):
        _same(a, b)
    for Lout in (max(L - 1, 0), L, 2 * L):
        for a, b in zip(port_const.z_packed(L, Lout, "complex128"),
                        ref_const.z_packed(L, Lout, "complex128")):
            _same(a, b)
    for a, b in zip(port_const.pack_index(L), ref_const.pack_index(L)):
        _same(a, b)


@pytest.mark.parametrize("pad_lanes", [True, False])
@pytest.mark.parametrize("L1,L2,Lout", [(1, 1, 2), (3, 2, 3), (6, 6, 6)])
def test_fused_matrices_bit_for_bit(L1, L2, Lout, pad_lanes):
    for a, b in zip(port_const.fused_matrices(L1, L2, Lout, pad_lanes),
                    ref_const.fused_matrices(L1, L2, Lout, pad_lanes)):
        _same(a, b)
    for a, b in zip(gaunt_fused_matrices(L1, L2, Lout, pad_lanes),
                    ref_fused_matrices(L1, L2, Lout, pad_lanes)):
        _same(a, b)


def test_so3_helpers_bit_for_bit():
    for args in [(1, 0, 1, 0, 2, 0), (2, 1, 2, -1, 2, 0), (3, 2, 2, -1, 3, -1)]:
        assert port_so3.gaunt_complex(*args) == ref_so3.gaunt_complex(*args)
    for bl in (2, 5, 9):
        for a, b in zip(port_so3.sphere_quadrature(bl), ref_so3.sphere_quadrature(bl)):
            _same(a, b)
    for angles in [(0.3, 1.1, -0.7), (2.0, 0.0, 0.5), (-1.2, 3.0, 2.2)]:
        _same(port_so3.wigner_D_real_packed(6, *angles), ref_so3.wigner_D_real_packed(6, *angles))


@pytest.mark.parametrize("L", range(0, 9))
def test_real_sph_harm_torch_matches_jax_twin(L):
    v = np.random.default_rng(L).normal(size=(5, 7, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = np.concatenate([v.reshape(-1, 3), [[0, 0, 1.0], [0, 0, -1.0]]]).astype(np.float32)
    got = port_so3.real_sph_harm_torch(L, torch.as_tensor(v))
    want = np.asarray(ref_so3.real_sph_harm_jax(L, jnp.asarray(v)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    exact = port_so3.real_sph_harm(L, v.astype(np.float64))
    got64 = port_so3.real_sph_harm_torch(L, torch.as_tensor(v, dtype=torch.float64))
    assert_close(got64.numpy(), exact, dtype="float64")


def test_real_sph_harm_torch_gradient_matches_jax():
    L = 4
    v = np.random.default_rng(3).normal(size=(6, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    W = np.random.default_rng(4).normal(size=(6, 25)).astype(np.float32)
    want = jax.grad(lambda r: jnp.sum(ref_so3.real_sph_harm_jax(L, r) * W))(jnp.asarray(v))
    t = torch.as_tensor(v).requires_grad_(True)
    (got,) = torch.autograd.grad((port_so3.real_sph_harm_torch(L, t) * torch.as_tensor(W)).sum(), t)
    assert_close(got.numpy(), np.asarray(want), dtype="float32")


@pytest.mark.parametrize("L1,L2,Lout", [(1, 1, 2), (2, 2, 4), (3, 2, 3), (4, 4, 4), (4, 3, 7)])
def test_cg_full_tensor_product_matches_reference(L1, L2, Lout):
    x1 = np.random.default_rng(L1).normal(size=(3, 4, (L1 + 1) ** 2)).astype(np.float32)
    x2 = np.random.default_rng(L2 + 9).normal(size=(1, 4, (L2 + 1) ** 2)).astype(np.float32)
    got = cg_full_tensor_product(torch.as_tensor(x1), torch.as_tensor(x2), L1, L2, Lout)
    want = np.asarray(ref_cg(jnp.asarray(x1), jnp.asarray(np.broadcast_to(x2, (3, 4, x2.shape[-1]))),
                             L1, L2, Lout))
    assert got.shape == want.shape
    assert_close(got.numpy(), want, dtype="float32")


def test_cg_weights_match_reference():
    L1, L2, Lout = 2, 2, 3
    x1 = np.random.default_rng(0).normal(size=(5, 9)).astype(np.float32)
    x2 = np.random.default_rng(1).normal(size=(5, 9)).astype(np.float32)
    rng = np.random.default_rng(2)
    w = {(l1, l2, l3): float(rng.normal()) for l1 in range(3) for l2 in range(3)
         for l3 in range(abs(l1 - l2), min(Lout, l1 + l2) + 1)}
    got = cg_full_tensor_product(torch.as_tensor(x1), torch.as_tensor(x2), L1, L2, Lout, w)
    want = np.asarray(ref_cg(jnp.asarray(x1), jnp.asarray(x2), L1, L2, Lout, w))
    assert_close(got.numpy(), want, dtype="float32")


@pytest.mark.parametrize("backend", ["dense_einsum", "fft", "packed", "rfft", "fused_hopper"])
def test_pairwise_product_is_equivariant(backend):
    """out(D x1, D x2) == D out(x1, x2) with the packed real Wigner-D."""
    L1, L2, Lout = 3, 2, 4
    angles = (0.4, 1.3, -2.1)
    D1, D2, D3 = (torch.as_tensor(port_so3.wigner_D_real_packed(L, *angles), dtype=torch.float32)
                  for L in (L1, L2, Lout))
    x1 = torch.as_tensor(np.random.default_rng(5).normal(size=(8, 16)), dtype=torch.float32)
    x2 = torch.as_tensor(np.random.default_rng(6).normal(size=(8, 9)), dtype=torch.float32)
    p = port_engine.plan(L1, L2, Lout, backend=backend, requires_grad=False, device="cpu")
    rot = p.apply(x1 @ D1.T, x2 @ D2.T)
    assert_close(rot.numpy(), (p.apply(x1, x2) @ D3.T).numpy(), dtype="float32", tier="transform")
