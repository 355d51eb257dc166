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



@pytest.fixture(autouse=True)
def isolated_engines():
    """Both engines as fresh for each test: default calibration and no
    cached plan, so a pick compared with the reference's is not one made
    under another test's calibration."""
    ref_engine.get_engine().clear()
    port_engine.get_engine().clear()
    yield
    ref_engine.get_engine().clear()
    port_engine.get_engine().clear()

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


def _rna_torch(t: torch.Tensor) -> torch.Tensor:
    """TF32 rounding, to nearest with ties away from zero (cvt.rna), on f32."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_torch(t: torch.Tensor):
    hi = _rna_torch(t)
    return hi, _rna_torch(t - hi)


@pytest.mark.parametrize("L1,L2,Lout", CASES + [(6, 6, 6), (6, 6, 12), (8, 8, 16)])
def test_pair_tf32_constants_are_exact_splits(L1, L2, Lout):
    """The pair kernel's constants: each part a TF32 value (low 13 mantissa
    bits zero), hi the TF32 rounding of the f32 matrix and lo that of the
    exact remainder, so hi + lo is the matrix to 2^-22 of each entry (22 of
    its 24 bits; the two dropped bits are below the 1e-5 the kernel is held
    to); zero padding to the fragment tiles; P's rows in the stated order
    within each group of 8 samples."""
    T1, T2, P = port_const.pair_matrices(L1, L2, Lout)
    parts = port_const.pair_matrices_tf32(L1, L2, Lout)
    Gp = parts[0].shape[1]
    assert Gp % 32 == 0 and Gp - 32 < P.shape[0] <= Gp
    order = np.array(port_const.PAIR_SAMPLE_ORDER)
    assert sorted(order) == list(range(8))
    Pp = np.zeros((Gp, parts[4].shape[1]), np.float32)
    Pp[:P.shape[0], :P.shape[1]] = P
    perm = (np.arange(Gp) // 8) * 8 + order[np.arange(Gp) % 8]
    for (hi, lo), M in zip((parts[0:2], parts[2:4], parts[4:6]), (T1, T2, Pp[perm])):
        assert hi.dtype == lo.dtype == np.float32 and hi.shape == lo.shape
        assert all(s % 8 == 0 for s in hi.shape)
        Mp = np.zeros(hi.shape, np.float32)
        Mp[:M.shape[0], :M.shape[1]] = M
        for part in (hi, lo):
            assert not (part.view(np.uint32) & 0x1FFF).any()
        assert np.array_equal(hi, _rna_torch(torch.as_tensor(Mp)).numpy())
        assert np.array_equal(lo, _rna_torch(torch.as_tensor(Mp - hi)).numpy())
        assert np.all(np.abs(Mp.astype(np.float64) - hi - lo) <= 2.0 ** -22 * np.abs(Mp))
    # the permuted rows are P's rows, in PAIR_SAMPLE_ORDER within each group of 8
    Phi = parts[4]
    for s in range(Gp // 8):
        for j in range(8):
            assert np.array_equal(Phi[8 * s + j], _rna_torch(torch.as_tensor(Pp[8 * s + order[j]])))


@pytest.mark.parametrize("L1,L2,Lout", [(1, 1, 2), (6, 6, 6), (8, 8, 16)])
def test_pair_fragments_are_the_split_matrices(L1, L2, Lout):
    """`pair_fragments` is `pair_matrices_tf32` in mma.sync m16n8k8 B-fragment
    order: lane 4 g + t of tile (k-tile, n-tile) holds (hi[t, g],
    hi[t + 4, g], lo[t, g], lo[t + 4, g]); T's fragments sample tile first."""
    T1h, T1l, T2h, T2l, Ph, Pl = port_const.pair_matrices_tf32(L1, L2, Lout)
    F1, F2, FP = port_const.pair_fragments(L1, L2, Lout)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for F, hi, lo, sample_first in ((F1, T1h, T1l, True), (F2, T2h, T2l, True),
                                    (FP, Ph, Pl, False)):
        K, N = hi.shape
        assert F.flags.c_contiguous and F.dtype == np.float32
        assert F.shape == ((N // 8, K // 8) if sample_first else (K // 8, N // 8)) + (32, 4)
        for kt in range(K // 8):
            for nt in range(N // 8):
                f = F[nt, kt] if sample_first else F[kt, nt]
                k, n = 8 * kt + t, 8 * nt + g
                want = np.stack([hi[k, n], hi[k + 4, n], lo[k, n], lo[k + 4, n]], -1)
                assert np.array_equal(f, want)


def _mma_3xtf32(a: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor) -> torch.Tensor:
    """a [B, K] f32 times the split (bh, bl) [K, N] as the pair kernel does
    it: a split on the fly, per k-step of 8 the terms lo.hi, hi.lo, hi.hi,
    each an exact product sum added to an f32 accumulator."""
    ah, al = _split_torch(a)
    acc = torch.zeros(a.shape[0], bh.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc.double() + x[:, s].double() @ y[s].double()).float()
    return acc


@pytest.mark.parametrize("L1,L2,Lout", [(6, 6, 6), (8, 8, 16)])
def test_pair_kernel_3xtf32_arithmetic_holds_pair_plain(L1, L2, Lout):
    """An emulation of the pair kernel's arithmetic (split rows, split and
    padded constants, P's permuted rows, f32 accumulation per k-step) is
    within the kernel's 1e-5 of `pair_plain`, and one TF32 pass is not."""
    T1h, T1l, T2h, T2l, Ph, Pl = (torch.as_tensor(a)
                                  for a in port_const.pair_matrices_tf32(L1, L2, Lout))
    T1, T2, P = (torch.as_tensor(a) for a in port_const.pair_matrices(L1, L2, Lout))
    rng = np.random.default_rng(19)
    B = 1024
    x1 = torch.as_tensor(rng.normal(size=(B, T1.shape[0])).astype(np.float32))
    x2 = torch.as_tensor(rng.normal(size=(B, T2.shape[0])).astype(np.float32))
    p1, p2 = (torch.nn.functional.pad(x, (0, T.shape[0] - x.shape[1]))
              for x, T in ((x1, T1h), (x2, T2h)))
    V = _mma_3xtf32(p1, T1h, T1l) * _mma_3xtf32(p2, T2h, T2l)
    Gp = V.shape[1]
    perm = (torch.arange(Gp) // 8) * 8 + torch.as_tensor(port_const.PAIR_SAMPLE_ORDER)[
        torch.arange(Gp) % 8]
    got = _mma_3xtf32(V[:, perm], Ph, Pl)[:, :P.shape[1]]
    want = pair_plain(x1, x2, T1, T2, P)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale
    # one TF32 pass (every operand of both products rounded once) misses it
    t = _rna_torch
    one = t((t(x1) @ t(T1)) * (t(x2) @ t(T2))) @ t(P)
    assert float((one - want).abs().max()) > 1e-5 * scale
