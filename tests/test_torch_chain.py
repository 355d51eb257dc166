"""The port's chain collocation product against the reference Pallas kernel
(interpret mode on the CPU), forward and backward, and the port's chain
plans against the reference's.

On the CPU the kernel wrapper runs its plain version inside the same
autograd Function the kernel uses, so these tests hold the Function's
hand-written backward against ``jax.grad`` of the reference's custom VJP.
Tolerance: the f32 identity tier, ``repro.testing.tol_for('float32')``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.kernels.gaunt_fused import gaunt_chain_fused_pallas
from repro.testing import assert_close
from repro_torch.core import engine as port_engine
from repro_torch.kernels.gaunt_fused import (chain_plain, gaunt_chain_fused_hopper,
                                             gaunt_chain_fused_torch,
                                             launch_chain_kernel)

CHAINS = [
    ((1, 1), 2),
    ((2, 2), 2),
    ((2, 1, 2), 3),
    ((2, 2, 2), 2),
    ((1, 2, 1, 2), 4),
]
B = 9


def _inputs(Ls, variant, gated, seed):
    """numpy operands (+ gate): 'sh' — all packed SH, exit at the chain's
    Lout; 'grid' — operand 0 a complex half grid, exit the product grid."""
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


def _ref(xs, Ls, Lout, entries, out_entry, gate):
    return gaunt_chain_fused_pallas(
        [jnp.asarray(x) for x in xs], Ls, Lout, entries=entries, out_entry=out_entry,
        interpret=True, gate=None if gate is None else tuple(jnp.asarray(g) for g in gate))


def _as_real(a):
    a = np.asarray(a)
    return np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a


@pytest.mark.parametrize("Ls,Lout", CHAINS)
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("variant", ["sh", "grid"])
def test_chain_matches_reference_kernel(Ls, Lout, gated, variant):
    xs, entries, gate = _inputs(Ls, variant, gated, seed=sum(Ls) + 7 * gated)
    out_entry = "grid" if variant == "grid" else "sh"
    Lo = sum(Ls) if variant == "grid" else Lout
    want = _as_real(_ref(xs, Ls, Lo, entries, out_entry, gate))
    txs = [torch.as_tensor(x) for x in xs]
    tgate = None if gate is None else tuple(torch.as_tensor(g) for g in gate)
    for fn in (gaunt_chain_fused_torch, gaunt_chain_fused_hopper):
        got = fn(txs, Ls, Lo, entries=entries, out_entry=out_entry, gate=tgate)
        assert got.shape == want.shape[: len(got.shape)]
        assert_close(_as_real(got.numpy()), want, dtype="float32")


@pytest.mark.parametrize("Ls,Lout", CHAINS)
@pytest.mark.parametrize("gated", [False, True])
def test_chain_function_backward_matches_jax_grad(Ls, Lout, gated):
    """The kernel's autograd Function (plain forward on the CPU, hand-written
    collocation VJP) against jax.grad through the reference custom VJP."""
    xs, entries, gate = _inputs(Ls, "sh", gated, seed=3 + sum(Ls))
    W = np.random.default_rng(11).normal(size=(B, (Lout + 1) ** 2)).astype(np.float32)
    n = len(xs)

    def ref_loss(*args):
        g = (args[n], args[n + 1]) if gated else None
        out = gaunt_chain_fused_pallas(list(args[:n]), Ls, Lout, interpret=True, gate=g)
        return jnp.sum(out * W)

    ref_args = [jnp.asarray(x) for x in xs] + ([jnp.asarray(g) for g in gate] if gated else [])
    want = jax.grad(ref_loss, argnums=tuple(range(len(ref_args))))(*ref_args)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in
              (list(xs) + (list(gate) if gated else []))]
    tgate = (leaves[n], leaves[n + 1]) if gated else None
    out = gaunt_chain_fused_hopper(leaves[:n], Ls, Lout, gate=tgate)
    got = torch.autograd.grad((out * torch.as_tensor(W)).sum(), leaves)
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w), dtype="float32")


@pytest.mark.parametrize("gated", [False, True])
def test_chain_function_double_backward_matches_plain(gated):
    """The Function's backward is differentiable: its second derivatives
    equal autograd's through the plain version (float64, CPU)."""
    Ls, Lout = (2, 1, 2), 3
    rng = np.random.default_rng(5)
    xs = [torch.as_tensor(rng.normal(size=(4, (L + 1) ** 2))) for L in Ls]
    gate = tuple(torch.as_tensor(rng.normal(size=(4,))) for _ in range(2)) if gated else None
    results = []
    for fn in (gaunt_chain_fused_hopper, gaunt_chain_fused_torch):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        g = tuple(t.clone().requires_grad_(True) for t in gate) if gated else None
        out = fn(leaves, Ls, Lout, gate=g, dtype="float64")
        (gx,) = torch.autograd.grad(out.pow(2).sum(), leaves[0], create_graph=True)
        results.append(torch.autograd.grad(gx.pow(2).sum(), leaves + list(g or ())))
    for a, b in zip(*results):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-10)


def test_kernel_wrapper_needs_cuda_and_f32():
    x = torch.zeros(4, 9)
    T = torch.zeros(9, 196)
    P = torch.zeros(196, 9)
    with pytest.raises(ValueError, match="CUDA"):
        launch_chain_kernel([x, x, x], [T, T, T], P)
    with pytest.raises(ValueError, match="CUDA"):
        launch_chain_kernel([x.bfloat16()] * 3, [T.bfloat16()] * 3, P)
    # bf16 storage works: bf16 rows and T, f32 P and output
    out = gaunt_chain_fused_hopper([x.bfloat16()] * 3, (2, 2, 2), 2)
    assert out.dtype == torch.float32 and torch.equal(out, torch.zeros(4, 9))
    assert torch.equal(chain_plain([x, x, x], [T, T, T], P), torch.zeros(4, 9))


@pytest.mark.parametrize("backend", port_engine.CHAIN_BACKENDS)
@pytest.mark.parametrize("gated", [False, True])
def test_chain_plan_matches_reference_tree(backend, gated):
    """Port chain plans on every backend (weights, output weights, gate) vs
    the reference's tree chain plan."""
    Ls, Lout = (2, 2, 2), 2
    rng = np.random.default_rng(21)
    x = rng.normal(size=(5, 3, 9)).astype(np.float32)
    ws = [rng.normal(size=(5, 3, 3)).astype(np.float32) for _ in Ls]
    wo = rng.normal(size=(5, 3, 3)).astype(np.float32)
    gp = ({"w1": rng.normal(size=(3, 4)).astype(np.float32),
           "w2": rng.normal(size=(4, 3)).astype(np.float32)} if gated else None)
    ref = ref_engine.plan_chain(Ls, Lout, backend="tree", gate=gated)
    xj = jnp.asarray(x)
    kw = {"gate_params": {k: jnp.asarray(v) for k, v in gp.items()}} if gated else {}
    want = np.asarray(ref.apply([xj] * 3, weights=[jnp.asarray(w) for w in ws],
                                w_out=jnp.asarray(wo), **kw))
    cp = port_engine.plan_chain(Ls, Lout, backend=backend, gate=gated)
    xt = torch.as_tensor(x)
    kw = {"gate_params": {k: torch.as_tensor(v) for k, v in gp.items()}} if gated else {}
    got = cp.apply([xt] * 3, weights=[torch.as_tensor(w) for w in ws],
                   w_out=torch.as_tensor(wo), **kw)
    assert cp.backend == backend
    assert_close(got.numpy(), want, dtype="float32")


def test_measured_chain_pick_on_cpu_is_a_cpu_candidate():
    eng = port_engine.GauntEngine()
    cp = eng.plan_chain((2, 2, 2), 2, tune="measure", batch_hint=64,
                        share_hint=(0, 0, 0), gate=True, device="cpu")
    key = eng.chain_measure_key((2, 2, 2), 2, "float32", 64, (0, 0, 0), True, "cpu")
    assert set(eng.measured_times[key]) == {"tree", "looped", "fused_torch"}
    assert cp.backend == min(eng.measured_times[key], key=eng.measured_times[key].get)
    assert eng.timing_runs == 1
    eng.plan_chain((2, 2, 2), 2, tune="measure", batch_hint=60,  # same rung: cached
                   share_hint=(0, 0, 0), gate=True, device="cpu")
    assert eng.timing_runs == 1


@pytest.mark.parametrize("measured_first", [False, True])
def test_pinned_chain_serves_the_pin_and_restores_the_pick(measured_first):
    """`pinned_chain` serves its backend inside the block without a timing
    run, and leaves the measured pick (or its absence) as it was, also when
    the block raises."""
    eng = port_engine.GauntEngine()
    kw = dict(tune="measure", batch_hint=64, share_hint=(0, 0, 0), gate=True, device="cpu")
    key = eng.chain_measure_key((2, 2, 2), 2, "float32", 64, (0, 0, 0), True, "cpu")
    if measured_first:
        eng.plan_chain((2, 2, 2), 2, **kw)
    before, runs = eng.measured_pick(key), eng.timing_runs
    for backend in ("tree", "fused_torch"):
        with eng.pinned_chain(key, backend):
            assert eng.plan_chain((2, 2, 2), 2, **kw).backend == backend
            assert eng.measured_pick(key) == backend
        assert eng.measured_pick(key) == before
    with pytest.raises(ZeroDivisionError), eng.pinned_chain(key, "tree"):
        1 / 0
    assert eng.measured_pick(key) == before and eng.timing_runs == runs


@pytest.mark.parametrize("backend", ["tree", "fused_torch"])
@pytest.mark.parametrize("gated", [False, True])
def test_chain_plan_resident_entry_and_exit_match_reference(backend, gated):
    """A Fourier-resident operand enters the chain as its half grid and the
    product leaves resident (out_basis='fourier'), gate included."""
    from repro.core.rep import Rep as RefRep
    from repro_torch.core.rep import Rep

    Ls = (2, 1)
    rng = np.random.default_rng(31)
    a = rng.normal(size=(6, 9)).astype(np.float32)
    b = rng.normal(size=(6, 4)).astype(np.float32)
    gp = ({"w1": rng.normal(size=(6, 3)).astype(np.float32),
           "w2": rng.normal(size=(3, 6)).astype(np.float32)} if gated else None)
    ref = ref_engine.plan_chain(Ls, 3, backend="tree", gate=gated)
    kw = {"gate_params": {k: jnp.asarray(v) for k, v in gp.items()}} if gated else {}
    want = ref.apply([RefRep.from_sh(jnp.asarray(a), 2).to_fourier("half"), jnp.asarray(b)],
                     out_basis="fourier", **kw)
    cp = port_engine.plan_chain(Ls, 3, backend=backend, gate=gated)
    kw = {"gate_params": {k: torch.as_tensor(v) for k, v in gp.items()}} if gated else {}
    got = cp.apply([Rep.from_sh(torch.as_tensor(a), 2).to_fourier("half"),
                    torch.as_tensor(b)], out_basis="fourier", **kw)
    assert got.is_fourier and got.form == "half" and got.L == 3
    assert_close(_as_real(got.data.numpy()),
                 _as_real(np.asarray(want.with_form("half").data)), dtype="float32")


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("Ls,Lout,entries,n_distinct", [
    ((2, 2, 2), 2, ("sh",) * 3, 86),
    ((1, 2, 1, 2), 4, ("sh",) * 4, 86),
    ((1, 1), 2, ("sh", "sh"), 14),
    ((2, 1, 2), 3, ("grid", "sh", "sh"), 144),
])
def test_bound_counts_distinct_sphere_points(Ls, Lout, entries, n_distinct):
    """The smoke test's bound counts one sample per distinct sphere point:
    one column per class with the class's rows of P summed gives the same
    output as the full grid."""
    from repro_torch.core import constants as port_c

    Ts, P = port_c.chain_matrices(Ls, Lout, entries, "sh", pad_lanes=False,
                                  dtype="float64")
    cls = _chip_smoke().sample_classes(Ts)
    assert int(cls.max()) + 1 == n_distinct
    first = np.array([np.flatnonzero(cls == k)[0] for k in range(n_distinct)])
    Pd = np.zeros((n_distinct, P.shape[1]))
    np.add.at(Pd, cls, P)
    rng = np.random.default_rng(0)
    flat = [torch.as_tensor(rng.normal(size=(7, T.shape[0]))) for T in Ts]
    gs, gb = (torch.as_tensor(rng.normal(size=(7, 1))) for _ in range(2))
    full = chain_plain(flat, [torch.as_tensor(T) for T in Ts], torch.as_tensor(P), gs, gb)
    less = chain_plain(flat, [torch.as_tensor(T[:, first]) for T in Ts],
                       torch.as_tensor(Pd), gs, gb)
    assert float((full - less).abs().max()) <= 1e-10 * max(1.0, float(full.abs().max()))


FOLD_CASES = [
    ((2, 2, 2), 2, ("sh",) * 3, "sh", True),    # the main path, gated
    ((2, 2, 2), 2, ("sh",) * 3, "sh", False),   # ... ungated
    ((1, 1), 2, ("sh", "sh"), "sh", False),      # n = 2
    ((1, 2, 1, 2), 4, ("sh",) * 4, "sh", True),  # n = 4
    ((1, 1), 2, ("sh", "sh"), "grid", True),     # an 'sh' -> 'grid' exit
]


@pytest.mark.parametrize("Ls,Lout,entries,out_entry,gated", FOLD_CASES)
def test_folded_chain_matrices_give_the_same_product_and_gradient(Ls, Lout, entries,
                                                                  out_entry, gated):
    """The chain route's folded matrices (one sample per distinct sphere
    point, P rows summed per point) against the full torus grid, forward
    and gradients of every operand and of the gate, in float64 through the
    kernel route's autograd Function."""
    from repro_torch.core import constants as port_c
    from repro_torch.kernels.gaunt_fused import _ChainFn

    Ts, P = port_c.chain_matrices(Ls, Lout, entries, out_entry, pad_lanes=False,
                                  dtype="float64")
    Tf, Pf = port_c.chain_matrices_folded(Ls, Lout, entries, out_entry, dtype="float64")
    reps, _ = port_c.sphere_point_classes(sum(Ls))
    assert Pf.shape == (len(reps), P.shape[1]) and Pf.shape[0] < P.shape[0]
    rng = np.random.default_rng(5)
    results = []
    for mats, proj in ((Ts, P), (Tf, Pf)):
        flat = [torch.tensor(rng.normal(size=(11, T.shape[0])), requires_grad=True)
                for T in mats]
        gate = ([torch.tensor(rng.normal(size=(11, 1)), requires_grad=True) for _ in range(2)]
                if gated else [None, None])
        out = _ChainFn.apply(tuple(torch.as_tensor(T) for T in mats), torch.as_tensor(proj),
                             *gate, *flat)
        w = torch.as_tensor(np.random.default_rng(6).normal(size=out.shape))
        leaves = flat + [g for g in gate if g is not None]
        results.append((out.detach(), torch.autograd.grad((out * w).sum(), leaves)))
        rng = np.random.default_rng(5)  # the same operands for the folded pass
    (o_full, g_full), (o_fold, g_fold) = results
    scale = max(1.0, float(o_full.abs().max()))
    assert float((o_fold - o_full).abs().max()) <= 1e-10 * scale
    for a, b in zip(g_fold, g_full):
        assert float((a - b).abs().max()) <= 1e-10 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("Ls,Lout,entries,out_entry", [
    ((2, 1, 2), 3, ("grid", "sh", "sh"), "sh"),
    ((1, 2, 1, 2), 6, ("sh", "sh", "grid", "sh"), "grid"),
])
def test_chain_with_a_grid_entry_is_not_folded(Ls, Lout, entries, out_entry):
    """'grid' entries are functions on the torus: the chain keeps every
    torus sample, exactly as `chain_matrices` builds them."""
    from repro_torch.core import constants as port_c

    Ts, P = port_c.chain_matrices(Ls, Lout, entries, out_entry, pad_lanes=False)
    Tf, Pf = port_c.chain_matrices_folded(Ls, Lout, entries, out_entry)
    assert np.array_equal(Pf, P) and all(np.array_equal(a, b) for a, b in zip(Tf, Ts))
    assert P.shape[0] == (2 * sum(Ls) + 2) ** 2


@pytest.mark.parametrize("L1,L2,Lout", [(1, 1, 2), (3, 2, 3), (6, 6, 6), (8, 8, 16)])
def test_pair_matrices_are_the_two_operand_fold(L1, L2, Lout):
    from repro_torch.core import constants as port_c

    (T1, T2), P = port_c.chain_matrices_folded((L1, L2), Lout, ("sh", "sh"), "sh")
    for a, b in zip(port_c.pair_matrices(L1, L2, Lout), (T1, T2, P)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_chain_route_runs_on_the_folded_matrices():
    """Both chain routes take the folded matrices when every entry is 'sh'
    (86 samples on the main path, not 196) and match the reference kernel."""
    from repro_torch.core import constants as port_c

    xs, entries, gate = _inputs((2, 2, 2), "sh", True, seed=3)
    Tf, Pf = port_c.chain_matrices_folded((2, 2, 2), 2, entries, "sh")
    assert Pf.shape == (86, 9)
    flat = [torch.as_tensor(x) for x in xs]
    gs, gb = (torch.as_tensor(g).reshape(-1, 1) for g in gate)
    want = chain_plain(flat, [torch.as_tensor(T) for T in Tf], torch.as_tensor(Pf), gs, gb)
    got = gaunt_chain_fused_hopper(flat, (2, 2, 2), 2, gate=tuple(torch.as_tensor(g)
                                                                  for g in gate))
    assert torch.equal(got, want)
    ref = np.asarray(_ref(xs, (2, 2, 2), 2, entries, "sh", gate))
    assert_close(got.numpy(), ref, dtype="float32")
