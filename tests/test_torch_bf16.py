"""bfloat16 storage in the port against the reference: the bf16 constants
bit for bit, the storage rule, the chain collocation product (both routes,
forward and gradients), every pairwise and conv_filter backend, chain
plans, `MaceGaunt` at ``compute_dtype='bfloat16'``, serving, and the bf16
pair kernel's fragment layout and arithmetic (emulated).

Semantics, as the reference's: operands and the sampling matrices T_i at
bf16, every sum in f32, P, the gate scalars and the kernel outputs f32,
plan outputs at bf16.  Tolerances: the chain routes read the same bf16
operands as the reference and sum in f32, so their outputs are held at the
f32 identity tier (3e-4); everything that rounds at bf16 on the way
(gradients cast back to bf16, plan exits, entries rounded after f32 work
that differs in the last bits) at the bf16 tiers of
`repro.testing.tol_for('bfloat16')`: identity 5e-2, transform 7e-2, loose
1.2e-1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import constants as ref_const
from repro.core import engine as ref_engine
from repro.core.gaunt import gaunt_product_numpy
from repro.kernels import gaunt_fused as ref_fused
from repro.testing import assert_close, tol_for
from repro_torch.core import constants as port_const
from repro_torch.core import engine as port_engine
from repro_torch.kernels import gaunt_fused as port_fused

REF_NAME = {"fused_torch": "fused_xla", "fused_hopper": "fused_pallas"}
BF16 = ml_dtypes.bfloat16


def _bits_ref(a: np.ndarray) -> np.ndarray:
    return np.asarray(a).astype(BF16).view(np.uint16)


def _bits_port(a: np.ndarray) -> np.ndarray:
    t = port_const.to_torch(a, "cpu", torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _as_real(a):
    a = np.asarray(a)
    return np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a


# --------------------------------------------------------------------------
# constants
# --------------------------------------------------------------------------


@pytest.mark.parametrize("Ls,Lout", [((2, 2, 2), 2), ((6, 6), 6), ((1, 2, 1, 2), 4)])
def test_bf16_constants_match_the_reference_bit_for_bit(Ls, Lout):
    """The bf16 chain matrices (lane-padded as the reference builds them,
    and folded as the port's routes take them: the reference's T columns at
    the distinct sphere points) and the dense Gaunt tensor equal the
    reference's ``astype('bfloat16')`` bit for bit."""
    entries = ("sh",) * len(Ls)
    Tr, Pr = ref_const.chain_matrices(Ls, Lout, entries, "sh", dtype="bfloat16")
    Tp, Pp = port_const.chain_matrices(Ls, Lout, entries, "sh", dtype="bfloat16")
    for a, b in zip((*Tp, Pp), (*Tr, Pr)):
        assert a.dtype == np.float32 and np.array_equal(_bits_port(a), np.asarray(b).view(np.uint16))
        assert np.array_equal(port_const.bf16_bits(a), _bits_port(a))
    reps, _ = port_const.sphere_point_classes(sum(Ls))
    Tf, _ = port_const.chain_matrices_folded(Ls, Lout, entries, "sh", dtype="bfloat16")
    for a, b in zip(Tf, Tr):
        assert np.array_equal(_bits_port(a), np.asarray(b)[:, reps].view(np.uint16))
    if len(Ls) == 2:
        T1, T2, _ = port_const.pair_matrices(*Ls, Lout, dtype="bfloat16")
        assert np.array_equal(_bits_port(T1), _bits_port(Tf[0]))
        assert np.array_equal(_bits_port(T2), _bits_port(Tf[1]))
        G = port_const.gaunt_dense(*Ls, Lout, "bfloat16")
        assert np.array_equal(_bits_port(G), np.asarray(
            ref_const.gaunt_dense(*Ls, Lout, "bfloat16")).view(np.uint16))


def test_bf16_rounding_is_torch_and_ml_dtypes_rounding():
    """`bf16_bits` rounds through f32 to nearest even, ties included, as
    torch's cast and ml_dtypes' do."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096),
                        # exact ties between two bf16 values, both parities
                        (np.arange(1, 65, dtype=np.uint32) << 16 | 0x8000).view(np.float32),
                        np.array([0.0, -0.0, 1.0, -2.5, 1 + 2 ** -8 + 2 ** -30])])
    want = torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    assert np.array_equal(port_const.bf16_bits(a), want.numpy().view(np.uint16))
    assert np.array_equal(port_const.bf16_bits(a), _bits_ref(a.astype(np.float32)))
    assert np.array_equal(port_const.bf16_bits(a), _bits_ref(a))


@pytest.mark.parametrize("L1,L2,Lout", [(1, 1, 2), (6, 6, 6), (8, 8, 16)])
def test_pair_bf16_fragments_are_the_bf16_matrices(L1, L2, Lout):
    """`pair_fragments_bf16`: T1, T2 at bf16, padded (d to 16, samples to
    32), in mma.sync m16n8k16 B-fragment order — lane 4 g + t of tile
    (sample n-tile, k-tile) holds T[16kt + 2t + (0, 1, 8, 9), 8nt + g] —
    beside the f32 mode's split P, unchanged."""
    T1, T2, _ = port_const.pair_matrices(L1, L2, Lout, dtype="bfloat16")
    F1, F2, FP = port_const.pair_fragments_bf16(L1, L2, Lout)
    assert np.array_equal(FP, port_const.pair_fragments(L1, L2, Lout)[2])
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for F, T in ((F1, T1), (F2, T2)):
        assert F.dtype == np.int16 and F.flags.c_contiguous
        NS, KT = F.shape[:2]
        assert F.shape[2:] == (32, 4) and NS == FP.shape[0] and NS % 4 == 0
        assert 16 * KT >= T.shape[0] > 16 * (KT - 1)
        bits = np.zeros((16 * KT, 8 * NS), np.uint16)
        bits[:T.shape[0], :T.shape[1]] = port_const.bf16_bits(T)
        for nt in range(NS):
            for kt in range(KT):
                k = 16 * kt + 2 * t
                want = np.stack([bits[k, 8 * nt + g], bits[k + 1, 8 * nt + g],
                                 bits[k + 8, 8 * nt + g], bits[k + 9, 8 * nt + g]], -1)
                assert np.array_equal(F[nt, kt].view(np.uint16), want)


def _rna(t: torch.Tensor) -> torch.Tensor:
    u = t.contiguous().view(torch.int32).to(torch.int64)
    return ((u + 0x1000) & 0xFFFFE000).to(torch.int32).view(torch.float32)


def _mma_3xtf32(a: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor) -> torch.Tensor:
    ah = _rna(a)
    al = _rna(a - ah)
    acc = torch.zeros(a.shape[0], bh.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc.double() + x[:, s].double() @ y[s].double()).float()
    return acc


@pytest.mark.parametrize("L1,L2,Lout", [(6, 6, 6), (8, 8, 16)])
def test_pair_kernel_bf16_arithmetic_holds_pair_plain(L1, L2, Lout):
    """An emulation of the bf16 mode's arithmetic — bf16 rows and T padded
    to 16, exact products summed into an f32 accumulator per k-step of 16,
    the product's samples permuted as `PAIR_SAMPLE_ORDER` into the 3xTF32
    projection — is within the kernel's 1e-5 of `pair_plain` on the same
    bf16 values."""
    T1, T2, _ = (torch.as_tensor(a) for a in port_const.pair_matrices(L1, L2, Lout,
                                                                        dtype="bfloat16"))
    P = torch.as_tensor(port_const.pair_matrices(L1, L2, Lout)[2])
    _, _, _, _, Ph, Pl = (torch.as_tensor(a) for a in port_const.pair_matrices_tf32(L1, L2, Lout))
    Gp = Ph.shape[0]
    rng = np.random.default_rng(23)
    x1, x2 = (torch.as_tensor(rng.normal(size=(512, T.shape[0])).astype(np.float32))
              .bfloat16() for T in (T1, T2))

    def sample(x, T):
        d16 = -(-T.shape[0] // 16) * 16
        xp = torch.nn.functional.pad(x.float(), (0, d16 - x.shape[1]))
        Tp = torch.nn.functional.pad(T, (0, Gp - T.shape[1], 0, d16 - T.shape[0]))
        acc = torch.zeros(x.shape[0], Gp, dtype=torch.float32)
        for k in range(0, d16, 16):
            acc = (acc.double() + xp[:, k:k + 16].double() @ Tp[k:k + 16].double()).float()
        return acc

    V = sample(x1, T1) * sample(x2, T2)
    perm = (torch.arange(Gp) // 8) * 8 + torch.as_tensor(port_const.PAIR_SAMPLE_ORDER)[
        torch.arange(Gp) % 8]
    got = _mma_3xtf32(V[:, perm], Ph, Pl)[:, :P.shape[1]]
    want = port_fused.pair_plain(x1, x2, T1.bfloat16(), T2.bfloat16(), P)
    assert want.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


# --------------------------------------------------------------------------
# the storage rule
# --------------------------------------------------------------------------

STORAGE_CASES = [
    (("bfloat16",) * 3, None),
    (("bfloat16", "float32", "bfloat16"), None),  # mixed: promotes to f32
    (("float32", "float32"), "bfloat16"),         # an explicit dtype wins
    (("bfloat16", "bfloat16"), "float32"),
    (("complex64", "float32"), None),             # complex -> its real width
    (("complex64", "bfloat16"), None),
    (("float16", "float16"), None),               # anything else stores at f32
]


@pytest.mark.parametrize("dts,dtype", STORAGE_CASES)
def test_storage_rule_matches_the_reference(dts, dtype):
    want = ref_fused._storage_dtype([jnp.zeros(3, d) for d in dts], dtype)
    got = port_fused._storage_dtype([torch.zeros(3, dtype=getattr(torch, d)) for d in dts],
                                    dtype)
    assert got == getattr(torch, want)
    got_t = port_fused._storage_dtype([torch.zeros(3, dtype=getattr(torch, d)) for d in dts],
                                      None if dtype is None else getattr(torch, dtype))
    assert got_t == got


# --------------------------------------------------------------------------
# the chain product
# --------------------------------------------------------------------------

CHAINS = [((1, 1), 2), ((2, 2, 2), 2), ((2, 1, 2), 3), ((1, 2, 1, 2), 4)]
B = 9


def _chain_inputs(Ls, variant, gated, seed):
    rng = np.random.default_rng(seed)
    xs, entries = [], []
    for i, L in enumerate(Ls):
        if variant == "grid" and i == 0:
            shape = (B, 2 * L + 1, L + 1)
            xs.append((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))
            entries.append("grid")
        else:
            xs.append(rng.normal(size=(B, (L + 1) ** 2)).astype(np.float32))
            entries.append("sh")
    gate = tuple(rng.normal(size=(B,)).astype(np.float32) for _ in range(2)) if gated else None
    return xs, tuple(entries), gate


@pytest.mark.parametrize("Ls,Lout", CHAINS)
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("variant", ["sh", "grid"])
def test_chain_bf16_matches_the_reference(Ls, Lout, gated, variant):
    """Both chain routes at bf16 storage against the reference's
    `gaunt_chain_fused_xla` and `gaunt_chain_fused_pallas(interpret=True)`
    at bf16: the same bf16 operands and T, f32 sums, so the outputs agree
    at the f32 identity tier."""
    xs, entries, gate = _chain_inputs(Ls, variant, gated, seed=40 + sum(Ls) + 7 * gated)
    out_entry = "grid" if variant == "grid" else "sh"
    Lo = sum(Ls) if variant == "grid" else Lout
    jx = [jnp.asarray(x) for x in xs]
    jg = None if gate is None else tuple(jnp.asarray(g) for g in gate)
    kw = dict(entries=entries, out_entry=out_entry, dtype="bfloat16", gate=jg)
    wants = [_as_real(ref_fused.gaunt_chain_fused_xla(jx, Ls, Lo, **kw)),
             _as_real(ref_fused.gaunt_chain_fused_pallas(jx, Ls, Lo, interpret=True, **kw))]
    txs = [torch.as_tensor(x) for x in xs]
    tgate = None if gate is None else tuple(torch.as_tensor(g) for g in gate)
    for fn in (port_fused.gaunt_chain_fused_torch, port_fused.gaunt_chain_fused_hopper):
        got = fn(txs, Ls, Lo, entries=entries, out_entry=out_entry, gate=tgate,
                 dtype="bfloat16")
        assert got.dtype in (torch.float32, torch.complex64)
        for want in wants:
            assert_close(_as_real(got.numpy()), want, dtype="float32")


@pytest.mark.parametrize("Ls,Lout", CHAINS)
@pytest.mark.parametrize("gated", [False, True])
def test_chain_bf16_gradients_match_jax_grad(Ls, Lout, gated):
    """Gradients through the kernel route's autograd Function at bf16 (V_i
    and U in f32, dx_i cast back to bf16) against jax.grad through the
    reference's custom VJP at bf16, at the bf16 tier; the all-bf16 operand
    case returns bf16 gradients, as the reference does."""
    xs, entries, gate = _chain_inputs(Ls, "sh", gated, seed=60 + sum(Ls))
    W = _rand((B, (Lout + 1) ** 2), 61)
    n = len(xs)

    def ref_loss(*args):
        g = (args[n], args[n + 1]) if gated else None
        out = ref_fused.gaunt_chain_fused_pallas(list(args[:n]), Ls, Lout, interpret=True,
                                                 dtype="bfloat16", gate=g)
        return jnp.sum(out * W)

    ref_args = [jnp.asarray(x) for x in xs] + ([jnp.asarray(g) for g in gate] if gated else [])
    want = jax.grad(ref_loss, argnums=tuple(range(len(ref_args))))(*ref_args)
    leaves = [torch.as_tensor(a).requires_grad_(True)
              for a in list(xs) + (list(gate) if gated else [])]
    tgate = (leaves[n], leaves[n + 1]) if gated else None
    out = port_fused.gaunt_chain_fused_hopper(leaves[:n], Ls, Lout, gate=tgate,
                                              dtype="bfloat16")
    got = torch.autograd.grad((out * torch.as_tensor(W)).sum(), leaves)
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w, np.float32), dtype="bfloat16")
    # bf16 operands: the operand gradients come back at bf16
    bl = [torch.as_tensor(x).bfloat16().requires_grad_(True) for x in xs]
    out = port_fused.gaunt_chain_fused_hopper(bl, Ls, Lout, gate=tgate)
    gb = torch.autograd.grad((out * torch.as_tensor(W)).sum(), bl)
    assert all(g.dtype == torch.bfloat16 for g in gb)


@pytest.mark.parametrize("gated", [False, True])
def test_chain_function_bf16_double_backward(gated):
    """The bf16 chain Function's backward is differentiable: its second
    derivatives match autograd's through the plain version at bf16."""
    Ls, Lout = (2, 1, 2), 3
    rng = np.random.default_rng(7)
    xs = [torch.as_tensor(rng.normal(size=(4, (L + 1) ** 2)).astype(np.float32)) for L in Ls]
    gate = (tuple(torch.as_tensor(rng.normal(size=(4,)).astype(np.float32)) for _ in range(2))
            if gated else None)
    results = []
    for fn in (port_fused.gaunt_chain_fused_hopper, port_fused.gaunt_chain_fused_torch):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        g = tuple(t.clone().requires_grad_(True) for t in gate) if gated else None
        out = fn(leaves, Ls, Lout, gate=g, dtype="bfloat16")
        (gx,) = torch.autograd.grad(out.pow(2).sum(), leaves[0], create_graph=True)
        results.append(torch.autograd.grad(gx.pow(2).sum(), leaves + list(g or ())))
    for a, b in zip(*results):
        assert torch.isfinite(a).all()
        assert_close(a.numpy(), b.numpy(), dtype="bfloat16", tier="loose")


def test_chain_bf16_rows_and_gate_storage():
    """Rows and T at bf16, P and the gate scalars at f32 — the seams the
    reference keeps at the accumulation dtype."""
    xs = [torch.randn(5, 9) for _ in range(3)]
    gate = (torch.randn(5), torch.randn(5))
    Ls, flat, lead, Ts, P, gs, gb = port_fused._chain_setup(
        xs, (2, 2, 2), 2, None, "sh", "bfloat16", gate)
    assert all(a.dtype == torch.bfloat16 for a in (*flat, *Ts))
    assert P.dtype == gs.dtype == gb.dtype == torch.float32
    assert torch.equal(gs[:, 0], gate[0]) and torch.equal(gb[:, 0], gate[1])


# --------------------------------------------------------------------------
# pairwise and conv_filter backends, chain plans
# --------------------------------------------------------------------------

PAIR_BF16 = port_engine.available_backends("pairwise", dtype="bfloat16", requires_grad=False)


def test_every_pairwise_backend_takes_bf16():
    assert PAIR_BF16 == ["dense_einsum", "fft", "direct", "packed", "rfft",
                         "fused_torch", "fused_hopper"]
    assert sorted(REF_NAME.get(b, b) for b in PAIR_BF16) == sorted(
        ref_engine.available_backends("pairwise", dtype="bfloat16", requires_grad=False))


@pytest.mark.parametrize("backend", PAIR_BF16)
def test_pairwise_backends_bf16_match_the_reference(backend):
    """Each backend at bf16 storage against the reference's same backend at
    bf16 (as tests/test_engine.py holds the reference against the oracle):
    bf16 operands in, bf16 out, at the bf16 identity tier."""
    L1, L2, Lout = 2, 2, 4
    x1, x2 = _rand((8, 9), 5), _rand((8, 9), 6)
    x1b, x2b = (jnp.asarray(x, jnp.bfloat16) for x in (x1, x2))
    p = ref_engine.plan(L1, L2, Lout, dtype="bfloat16", backend=REF_NAME.get(backend, backend),
                        requires_grad=False)
    want = np.asarray(jax.jit(p.apply)(x1b, x2b), np.float32)
    tp = port_engine.plan(L1, L2, Lout, dtype="bfloat16", backend=backend,
                          requires_grad=False, device="cpu")
    got = tp.apply(torch.as_tensor(x1).bfloat16(), torch.as_tensor(x2).bfloat16())
    assert got.dtype == torch.bfloat16 and tp.key.dtype == "bfloat16"
    assert_close(got.float().numpy(), want, dtype="bfloat16")
    oracle = gaunt_product_numpy(np.asarray(x1b, np.float32), np.asarray(x2b, np.float32),
                                 L1, L2, Lout)
    assert_close(got.float().numpy(), oracle, dtype="bfloat16")
    if backend == "fused_hopper":  # the public wrapper of the pairwise path
        from repro_torch.kernels.ops import gaunt_tp_fused

        with torch.no_grad():
            viaops = gaunt_tp_fused(torch.as_tensor(x1).bfloat16(),
                                    torch.as_tensor(x2).bfloat16(), L1, L2, Lout,
                                    device="cpu", dtype="bfloat16")
        assert torch.equal(viaops, got)


@pytest.mark.parametrize("backend", port_engine.available_backends(
    "conv_filter", dtype="bfloat16", requires_grad=False))
def test_conv_filter_backends_bf16_match_the_reference(backend):
    L1, L2, Lout = 2, 2, 3
    x = _rand((10, 9), 12)
    v = np.random.default_rng(13).normal(size=(10, 3))
    r = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    p = ref_engine.plan(L1, L2, Lout, kind="conv_filter", dtype="bfloat16",
                        backend=REF_NAME.get(backend, backend), requires_grad=False)
    want = jax.jit(p.apply)(jnp.asarray(x), jnp.asarray(r))
    tp = port_engine.plan(L1, L2, Lout, kind="conv_filter", dtype="bfloat16", backend=backend,
                          requires_grad=False, device="cpu")
    got = tp.apply(torch.as_tensor(x), torch.as_tensor(r))
    # bf16 out; the eSCN path's last rotation promotes its bf16 exit to f32
    assert str(got.dtype) == f"torch.{want.dtype.name}"
    assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype="bfloat16")


@pytest.mark.parametrize("backend", ["dense_einsum", "fused_torch"])
def test_channel_mix_bf16_matches_the_reference(backend):
    x1, x2, w = _rand((3, 2, 9), 70), _rand((3, 3, 4), 71), _rand((2, 3, 5), 72)
    p = ref_engine.plan(2, 1, 3, kind="channel_mix", dtype="bfloat16",
                        backend=REF_NAME.get(backend, backend), requires_grad=False)
    want = np.asarray(p.apply(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)), np.float32)
    tp = port_engine.plan(2, 1, 3, kind="channel_mix", dtype="bfloat16", backend=backend,
                          requires_grad=False, device="cpu")
    got = tp.apply(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(w))
    assert got.dtype == torch.bfloat16
    assert_close(got.float().numpy(), want, dtype="bfloat16")


@pytest.mark.parametrize("backend", port_engine.CHAIN_BACKENDS)
@pytest.mark.parametrize("gated", [False, True])
def test_chain_plan_bf16_matches_the_reference(backend, gated):
    """Port chain plans at bf16 (weights, output weights, gate) against the
    reference's tree and fused_xla chain plans at bf16: bf16 out."""
    Ls, Lout = (2, 2, 2), 2
    rng = np.random.default_rng(81)
    x = rng.normal(size=(5, 3, 9)).astype(np.float32)
    ws = [rng.normal(size=(5, 3, 3)).astype(np.float32) for _ in Ls]
    wo = rng.normal(size=(5, 3, 3)).astype(np.float32)
    gp = ({"w1": rng.normal(size=(3, 4)).astype(np.float32),
           "w2": rng.normal(size=(4, 3)).astype(np.float32)} if gated else None)
    cp = port_engine.plan_chain(Ls, Lout, backend=backend, gate=gated, dtype="bfloat16")
    kw = {"gate_params": {k: torch.as_tensor(v) for k, v in gp.items()}} if gated else {}
    got = cp.apply([torch.as_tensor(x)] * 3, weights=[torch.as_tensor(w) for w in ws],
                   w_out=torch.as_tensor(wo), **kw)
    assert cp.backend == backend and cp.dtype == "bfloat16" and got.dtype == torch.bfloat16
    kw = {"gate_params": {k: jnp.asarray(v) for k, v in gp.items()}} if gated else {}
    for ref_backend in ("tree", "fused_xla"):
        ref = ref_engine.plan_chain(Ls, Lout, backend=ref_backend, gate=gated, dtype="bfloat16")
        want = ref.apply([jnp.asarray(x)] * 3, weights=[jnp.asarray(w) for w in ws],
                         w_out=jnp.asarray(wo), **kw)
        assert want.dtype == jnp.bfloat16
        assert_close(got.float().numpy(), np.asarray(want, np.float32), dtype="bfloat16")


def test_bf16_plans_and_measured_chain_key():
    """bf16 plans key on 'bfloat16'; the measured chain pick times its
    candidates at bf16 (f32 synthetic gate weights, as the models' are);
    'auto' resolves to float32 under heuristic tuning."""
    eng = port_engine.GauntEngine()
    cp = eng.plan_chain((2, 2, 2), 2, tune="measure", batch_hint=64, share_hint=(0, 0, 0),
                        gate=True, device="cpu", dtype="bfloat16")
    key = eng.chain_measure_key((2, 2, 2), 2, "bfloat16", 64, (0, 0, 0), True, "cpu")
    assert set(eng.measured_times[key]) == {"tree", "looped", "fused_torch"}
    assert cp.dtype == "bfloat16" and eng.timing_runs == 1
    assert eng.plan_chain((2, 2, 2), 2, dtype="auto", device="cpu").dtype == "float32"
    assert eng.timing_runs == 1
    assert port_engine._dtype_str(torch.bfloat16) == "bfloat16"


# --------------------------------------------------------------------------
# the model and serving
# --------------------------------------------------------------------------

SMALL = dict(channels=4, n_layers=2, L=2, L_edge=3, n_species=4, compute_dtype="bfloat16")


def _mol(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n), (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)


def _close_forces(got, want, tol):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol * np.abs(np.asarray(want)).max(), err


def test_equi_linear_promotes_a_bf16_operand_as_jnp_does():
    from repro.models.equivariant import equi_linear as ref_equi_linear
    from repro_torch.models.equivariant import equi_linear

    w, x = _rand((3, 4, 5), 90), _rand((2, 4, 9), 91)
    want = np.asarray(ref_equi_linear(jnp.asarray(w), jnp.asarray(x, jnp.bfloat16), 2))
    got = equi_linear(torch.as_tensor(w), torch.as_tensor(x).bfloat16(), 2)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert_close(got.numpy(), want, dtype="float32")


@pytest.mark.parametrize("grid_gate", ["off", "on"])
@pytest.mark.parametrize("route", ["tree", "fused_hopper"])
def test_mace_bf16_energy_forces_match_the_reference(grid_gate, route, monkeypatch):
    """`MaceGaunt` at compute_dtype='bfloat16' on converted parameters
    against the reference's at bf16 (its tree chain), with the port's chain
    on the tree and on the kernel route's autograd Function: energy at the
    bf16 identity tier, forces at the loose tier."""
    from repro.configs.gaunt_ff import gaunt_mace_ff as ref_cfg
    from repro.models.equivariant import MaceGaunt as RefMace
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.equivariant import MaceGaunt

    kw = dict(SMALL, grid_gate=grid_gate)
    ref = RefMace(dataclasses.replace(ref_cfg, **kw))
    params = ref.init(jax.random.PRNGKey(0))
    tune = "heuristic" if route == "tree" else "measure"
    monkeypatch.setattr(port_engine.GauntEngine, "_select_chain",
                        lambda self, *a, **k: route)
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, chain_tune=tune, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    sp, pos = _mol(5, 1)
    e_ref, f_ref = ref.energy_forces(params, jnp.asarray(sp), jnp.asarray(pos))
    e, f = model.energy_forces(torch.as_tensor(sp), torch.as_tensor(pos))
    assert e.dtype == f.dtype == torch.float32
    assert_close(e.numpy(), np.asarray(e_ref), dtype="bfloat16")
    _close_forces(f.numpy(), np.asarray(f_ref), tol_for("bfloat16", "loose"))
    # the chain really ran at bf16: the f32 model differs
    model32 = MaceGaunt(dataclasses.replace(gaunt_mace_ff, chain_tune=tune,
                                            **dict(kw, compute_dtype="float32")), device="cpu")
    model32.load_state_dict(model.state_dict())
    e32, _ = model32.energy_forces(torch.as_tensor(sp), torch.as_tensor(pos))
    assert float(e32) != float(e)


def test_served_bf16_equals_direct():
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine

    cfg = dataclasses.replace(gaunt_mace_ff, **dict(SMALL, n_layers=1), chain_tune="measure",
                              grid_gate="on")
    model = MaceGaunt(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    eng = EquivariantServeEngine(model, n_slots=3, max_atoms=6, warmup=True)
    reqs = [EquivariantRequest(*_mol(n, n), rid=i) for i, n in enumerate((2, 4, 6))]
    out = eng.run(reqs)
    assert all(r.done and not r.rejected for r in out)
    for r in out:
        e, f = model.energy_forces(torch.as_tensor(r.species), torch.as_tensor(r.pos))
        assert r.forces.dtype == np.float32 and np.isfinite(r.energy)
        assert abs(r.energy - float(e)) <= tol_for("bfloat16") * max(1.0, abs(float(e)))
        _close_forces(r.forces, f.numpy(), tol_for("bfloat16", "loose"))
