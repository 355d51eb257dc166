"""The port's pairwise Gaunt tensor product against the reference: every
pairwise backend against the reference's same backend and the dense oracle
(`gaunt_einsum_reference`), per-degree weights with leading dims,
`GauntTensorProduct` for each conversion and conv, and the float64 paths
against the complex128 numpy oracle.

On the CPU the ``fused_hopper`` backend runs the kernel's plain version; its
reference twin ``fused_pallas`` runs the Pallas kernel in interpret mode.
Tolerances: `repro.testing.tol_for` — f32 identity 3e-4, f64 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.cg import gaunt_einsum_reference as ref_oracle
from repro.core.gaunt import GauntTensorProduct as RefTP
from repro.core.gaunt import gaunt_product_numpy as ref_numpy_product
from repro.testing import assert_close
from repro_torch.core import constants as port_const
from repro_torch.core import engine as port_engine
from repro_torch.core.cg import gaunt_einsum_reference
from repro_torch.core.gaunt import GauntTensorProduct, gaunt_product_numpy
from repro_torch.kernels.gaunt_fused import pair_plain

REF_NAME = {"fused_torch": "fused_xla", "fused_hopper": "fused_pallas"}
PAIR_BACKENDS = ["dense_einsum", "fft", "direct", "packed", "rfft",
                 "fused_torch", "fused_hopper"]
CASES = [(1, 1, 2), (2, 2, 4), (3, 2, 3), (4, 4, 8)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_plan(L1, L2, Lout, backend, **kw):
    return port_engine.plan(L1, L2, Lout, backend=backend, requires_grad=False,
                            device="cpu", **kw)


def _ref_apply(L1, L2, Lout, backend, *args):
    """The reference plan on ``backend``'s twin, jitted (one compile, where
    eager dispatch compiles each shifted copy of the direct conv)."""
    p = ref_engine.plan(L1, L2, Lout, backend=REF_NAME.get(backend, backend),
                        requires_grad=False)
    return np.asarray(jax.jit(p.apply)(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("backend", PAIR_BACKENDS)
@pytest.mark.parametrize("B", [1, 7, 300])
@pytest.mark.parametrize("L1,L2,Lout", CASES)
def test_pairwise_backend_matches_reference(L1, L2, Lout, B, backend):
    x1 = _rand((B, (L1 + 1) ** 2), 1 + B)
    x2 = _rand((B, (L2 + 1) ** 2), 2 + B)
    got = _port_plan(L1, L2, Lout, backend).apply(torch.as_tensor(x1), torch.as_tensor(x2))
    assert got.dtype == torch.float32 and got.shape == (B, (Lout + 1) ** 2)
    want = _ref_apply(L1, L2, Lout, backend, x1, x2)
    oracle = np.asarray(ref_oracle(jnp.asarray(x1), jnp.asarray(x2), L1, L2, Lout))
    assert_close(got.numpy(), want, dtype="float32")
    assert_close(got.numpy(), oracle, dtype="float32")


@pytest.mark.parametrize("backend", PAIR_BACKENDS)
def test_pairwise_weights_and_leading_dims(backend):
    """Per-degree weights w1/w2/w3 (the paper's w_{l1} w_{l2} w_l hooks) on
    operands with two leading dims, one of them broadcast in x2."""
    L1, L2, Lout = 3, 2, 4
    x1 = _rand((2, 5, (L1 + 1) ** 2), 3)
    x2 = _rand((1, 5, (L2 + 1) ** 2), 4)
    w1, w2, w3 = (_rand((2, 5, L + 1), 5 + L) for L in (L1, L2, Lout))
    got = _port_plan(L1, L2, Lout, backend).apply(
        *(torch.as_tensor(a) for a in (x1, x2, w1, w2, w3)))
    x2b = np.broadcast_to(x2, (2, 5, x2.shape[-1]))
    want = _ref_apply(L1, L2, Lout, backend, x1, x2b, w1, w2, w3)
    assert got.shape == want.shape == (2, 5, (Lout + 1) ** 2)
    assert_close(got.numpy(), want, dtype="float32")


@pytest.mark.parametrize("conversion,conv", [
    ("dense", "fft"), ("dense", "direct"), ("dense", "auto"),
    ("packed", "fft"), ("packed", "direct"),
    ("half", "rfft"), ("half", "fft"), ("half", "direct"),
])
def test_gaunt_tensor_product_matches_reference(conversion, conv):
    L1, L2, Lout = 3, 3, 5
    x1 = _rand((6, (L1 + 1) ** 2), 7)
    x2 = _rand((6, (L2 + 1) ** 2), 8)
    w1 = _rand((6, L1 + 1), 9)
    tp = GauntTensorProduct(L1, L2, Lout, conversion=conversion, conv=conv, device="cpu")
    ref = RefTP(L1, L2, Lout, conversion=conversion, conv=conv)
    assert tp.backend == ref.backend and tp.conv == ref.conv
    got = tp(torch.as_tensor(x1), torch.as_tensor(x2), w1=torch.as_tensor(w1))
    want = np.asarray(jax.jit(ref.__call__)(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w1)))
    assert_close(got.numpy(), want, dtype="float32")


def test_gaunt_tensor_product_auto_backend():
    tp = GauntTensorProduct(2, 2, 4, backend="auto", batch_hint=64, device="cpu")
    assert tp.backend in port_engine.available_backends("pairwise")
    x1, x2 = _rand((4, 9), 10), _rand((4, 9), 11)
    got = tp(torch.as_tensor(x1), torch.as_tensor(x2))
    assert_close(got.numpy(), np.asarray(ref_oracle(jnp.asarray(x1), jnp.asarray(x2), 2, 2, 4)),
                 dtype="float32")


def test_numpy_oracle_is_the_reference_bit_for_bit():
    x1 = np.random.default_rng(12).normal(size=(4, 16))
    x2 = np.random.default_rng(13).normal(size=(4, 9))
    assert np.array_equal(gaunt_product_numpy(x1, x2, 3, 2, 4),
                          ref_numpy_product(x1, x2, 3, 2, 4))


@pytest.mark.parametrize("backend", ["dense_einsum", "fft", "direct", "packed", "rfft"])
def test_float64_backends_match_numpy_oracle(backend):
    """f64 storage reaches the complex128 oracle at the f64 identity tier."""
    L1, L2, Lout = 3, 2, 5
    x1 = np.random.default_rng(14).normal(size=(5, (L1 + 1) ** 2))
    x2 = np.random.default_rng(15).normal(size=(5, (L2 + 1) ** 2))
    p = port_engine.plan(L1, L2, Lout, backend=backend, dtype="float64", device="cpu")
    got = p.apply(torch.as_tensor(x1), torch.as_tensor(x2))
    assert got.dtype == torch.float64
    assert_close(got.numpy(), gaunt_product_numpy(x1, x2, L1, L2, Lout), dtype="float64")
    assert_close(gaunt_einsum_reference(torch.as_tensor(x1), torch.as_tensor(x2),
                                        L1, L2, Lout).numpy(),
                 gaunt_product_numpy(x1, x2, L1, L2, Lout), dtype="float64")


@pytest.mark.parametrize("L1,L2,Lout", CASES + [(6, 6, 6), (8, 8, 16)])
def test_folded_pair_matrices_compute_the_same_product(L1, L2, Lout):
    """One sample per distinct sphere point, projection rows summed per
    point: the same product as the full torus grid, in float64."""
    (T1, T2), P = port_const.chain_matrices((L1, L2), Lout, ("sh", "sh"), "sh",
                                            pad_lanes=False, dtype="float64")
    F1, F2, Pf = port_const.pair_matrices(L1, L2, Lout, dtype="float64")
    reps, cls = port_const.sphere_point_classes(L1 + L2)
    N = 2 * (L1 + L2) + 2
    assert F1.shape[1] == len(reps) == 2 + (N // 2 - 1) * N
    M = np.concatenate([T1, T2])
    assert np.abs(M - M[:, reps[cls]]).max() <= 1e-12 * np.abs(M).max()
    x1 = torch.as_tensor(np.random.default_rng(16).normal(size=(7, T1.shape[0])))
    x2 = torch.as_tensor(np.random.default_rng(17).normal(size=(7, T2.shape[0])))
    full = pair_plain(x1, x2, *(torch.as_tensor(a) for a in (T1, T2, P)))
    folded = pair_plain(x1, x2, *(torch.as_tensor(a) for a in (F1, F2, Pf)))
    assert_close(folded.numpy(), full.numpy(), dtype="float64")
    assert np.array_equal(port_const.pair_matrices(L1, L2, Lout)[0],
                          F1.astype(np.float32))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("Ltot,n_distinct", [(2, 14), (12, 314), (16, 546)])
def test_sphere_point_classes_match_the_numeric_classes(Ltot, n_distinct):
    """The index arithmetic of `sphere_point_classes` finds the same
    partition as the smoke test's numeric `sample_classes`, which its bound
    counts."""
    L1 = Ltot // 2
    (T1, T2), _ = port_const.chain_matrices((L1, Ltot - L1), 0, ("sh", "sh"), "sh",
                                            pad_lanes=False, dtype="float64")
    numeric = _chip_smoke().sample_classes([T1, T2])
    reps, cls = port_const.sphere_point_classes(Ltot)
    assert len(reps) == n_distinct == int(numeric.max()) + 1
    assert np.array_equal(cls, numeric)


def test_chip_smoke_pairwise_phases_rehearse_on_cpu():
    """The smoke test's pairwise phases at a small size on the CPU, where the
    kernel routes run their plain versions."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    assert cs.phase_pair_vs_plain(cpu, 64) == 0.0
    launches, (x1, x2) = cs.phase_pair_main(cpu, 64)
    assert launches == 0 and x1.shape == (64, 49)
    cs.phase_fig1a(cpu, Ls=(1,), rows=2, channels=4)
    cs.phase_conv_filter(cpu, Ls=(1,), edges=16, pinned_L=2)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("L1,L2,Lout,flops_per_row",
                         [(2, 2, 2, 237), (3, 2, 3, None), (6, 6, 6, 15257)])
def test_pair_bound_counts_gaunt_nonzeros(L1, L2, Lout, flops_per_row):
    """The smoke test's sparse count keeps exactly the nonzeros of the
    reference's exact real Gaunt tensor, and the contraction over those
    alone gives the dense product (float64)."""
    from repro.core.so3 import real_gaunt_tensor as ref_real_gaunt

    smoke = _chip_smoke()
    Gt = port_const.gaunt_dense(L1, L2, Lout, "float64")
    flops, _, nnz, pairs = smoke.pair_work_sparse(1, Gt)
    ref = np.asarray(ref_real_gaunt(L1, L2, Lout))
    kept = np.abs(Gt) > 1e-9 * np.abs(Gt).max()
    assert nnz == int((np.abs(ref) > 1e-9 * np.abs(ref).max()).sum()) == int(kept.sum())
    assert flops == pairs + 2 * nnz
    if flops_per_row is not None:
        assert flops == flops_per_row
    x1, x2 = (torch.as_tensor(_rand((7, (L + 1) ** 2), s).astype(np.float64))
              for s, L in ((0, L1), (1, L2)))
    dense = torch.einsum("bi,bj,ijk->bk", x1, x2, torch.as_tensor(Gt))
    sparse = torch.einsum("bi,bj,ijk->bk", x1, x2, torch.as_tensor(np.where(kept, Gt, 0.0)))
    assert float((dense - sparse).abs().max()) <= 1e-10 * max(1.0, float(dense.abs().max()))
    d1, d2, dout = Gt.shape
    G = port_const.pair_matrices(L1, L2, Lout)[2].shape[0]
    assert flops < smoke.pair_work(1, d1, d2, G, dout)[0]
