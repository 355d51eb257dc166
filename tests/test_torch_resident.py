"""Basis residency in the port — twins of the unsharded tests of
tests/test_resident_chain.py and tests/test_resident_batched.py: the
conversion counters prove the elisions, and the resident routes match the
non-resident ones and the reference on the same numpy inputs.

The port runs eagerly, so its counters tick once per call; the reference's
tick once per jit trace, and on eager calls the two agree (held below).
Tolerances: the reference tests' own bounds; the f32 identity tier
(``repro.testing.tol_for('float32')``) against the reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import rep as ref_rep
from repro.testing import assert_close, random_array, random_irreps, random_unit_vectors
from repro_torch.configs.gaunt_ff import EquivariantConfig
from repro_torch.core import engine, rep
from repro_torch.core.cg import gaunt_einsum_reference
from repro_torch.core.conv import EquivariantConv, WignerBlocks
from repro_torch.core.irreps import num_coeffs
from repro_torch.core.manybody import manybody_selfmix
from repro_torch.core.rep import Rep
from repro_torch.models.convert import segnn_params_from_jax, selfmix_params_from_jax
from repro_torch.models.equivariant import (MaceGaunt, SegnnNBody, SelfmixLayer, _gate_sh,
                                            _resolve_grid_gate)


def _rand(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _count(fn):
    """(s2f, f2s) conversions inside ``fn``, scoped and restored."""
    with rep.conversion_stats(fresh=True) as c:
        fn()
    return c["sh_to_fourier"], c["fourier_to_sh"]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=atol,
                               atol=atol)


# --------------------------------------------------------------------------
# counters: chains beat the looped path by >= 1 interior pair
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["tree", "looped"])
def test_manybody_chain_eliminates_interior_pairs(backend):
    """tree pays one entry per operand and one exit; the looped backend
    pays the pre-residency fold's 2(n-1) entries and n-1 exits, which is
    what a loop of pairwise plans pays in the reference (counted there on
    the same inputs)."""
    nu, L = 3, 2
    xs = [_rand((4, num_coeffs(L)), i) for i in range(nu)]

    def looped():
        acc, La = xs[0], L
        for x in xs[1:]:
            acc = engine.plan(La, L, La + L, backend="fft", device="cpu").apply(acc, x)
            La += L

    def ref_looped():
        acc, La = jnp.asarray(xs[0].numpy()), L
        for x in xs[1:]:
            acc = ref_engine.plan(La, L, La + L, backend="fft").apply(acc, jnp.asarray(x.numpy()))
            La += L

    cp = engine.plan_chain((L,) * nu, backend=backend)
    loop, chain = _count(looped), _count(lambda: cp.apply(xs))
    with ref_rep.conversion_stats(fresh=True) as c:
        ref_looped()
    assert loop == (c["sh_to_fourier"], c["fourier_to_sh"]) == (2 * (nu - 1), nu - 1)
    assert chain == ((nu, 1) if backend == "tree" else loop)
    if backend == "tree":
        assert min(loop[0] - chain[0], loop[1] - chain[1]) >= 1
    acc = gaunt_einsum_reference(xs[0], xs[1], L, L)
    want = gaunt_einsum_reference(acc, xs[2], 2 * L, L)
    _close(cp.apply(xs), want, 2e-3)


def test_selfmix_shared_operand_single_conversion():
    """B_nu = A (x) A (x) A with per-operand weights: one degree-resolved
    conversion serves all nu operands, as in the reference."""
    L, nu = 2, 3
    x = _rand((3, num_coeffs(L)), 10)
    ws = [_rand((3, L + 1), 20 + i) for i in range(nu)]
    assert _count(lambda: manybody_selfmix(x, L, nu, Lout=L, weights=ws)) == (1, 1)
    from repro.core.manybody import manybody_selfmix as ref_selfmix

    with ref_rep.conversion_stats(fresh=True) as c:
        want = ref_selfmix(jnp.asarray(x.numpy()), L, nu, Lout=L,
                           weights=[jnp.asarray(w.numpy()) for w in ws])
    assert (c["sh_to_fourier"], c["fourier_to_sh"]) == (1, 1)
    assert_close(manybody_selfmix(x, L, nu, Lout=L, weights=ws).numpy(), np.asarray(want),
                 dtype="float32")


def test_boundary_plan_resident_output_feeds_next_product():
    """A resident output Rep enters the next chain with no round trip."""
    L = 2
    x1, x2, x3 = (_rand((4, num_coeffs(L)), 40 + i) for i in range(3))
    p = engine.plan(L, L, 2 * L, backend="fft", options={"boundary": ("sh", "sh", "fourier")},
                    device="cpu")

    def resident():
        mid = p.apply(x1, x2)
        engine.plan_chain((2 * L, L), Lout=L).apply([mid, x3])

    assert _count(resident) == (3, 1)  # looped would be (4, 2)
    got = engine.plan_chain((2 * L, L), Lout=L).apply([p.apply(x1, x2), x3])
    acc = gaunt_einsum_reference(gaunt_einsum_reference(x1, x2, L, L), x3, 2 * L, L, L)
    _close(got, acc, 2e-3)


@pytest.mark.parametrize("backend", ["fft", "direct", "packed", "rfft"])
@pytest.mark.parametrize("bound", [("fourier", "sh", "sh"), ("sh", "fourier", "sh"),
                                   ("fourier", "fourier", "sh"), ("sh", "sh", "fourier")])
def test_boundary_backends_match_reference(backend, bound):
    """Every spectral backend takes and returns resident operands, equal to
    the reference's boundary plans on the same inputs."""
    L1, L2 = 2, 1
    Lout = L1 + L2 if bound[2] == "fourier" else 2
    x1, x2 = random_irreps(L1, (5,), seed=1), random_irreps(L2, (5,), seed=2)
    opts = {"boundary": bound}
    rp = ref_engine.plan(L1, L2, Lout, backend=backend, options=opts)
    pp = engine.plan(L1, L2, Lout, backend=backend, options=opts, device="cpu")
    assert pp.key.opt("boundary") == bound

    ra = [ref_rep.Rep.from_sh(jnp.asarray(a), L) for a, L in ((x1, L1), (x2, L2))]
    ta = [Rep.from_sh(torch.as_tensor(a), L) for a, L in ((x1, L1), (x2, L2))]
    rin = [r.to_fourier("dense") if f == "fourier" else r.data for r, f in zip(ra, bound)]
    tin = [r.to_fourier("dense") if f == "fourier" else r.data for r, f in zip(ta, bound)]
    want, got = rp.apply(*rin), pp.apply(*tin)
    if bound[2] == "fourier":
        assert isinstance(got, Rep) and got.is_fourier and got.L == L1 + L2
        want, got = want.to_sh().data, got.to_sh().data
    assert_close(got.numpy(), np.asarray(want), dtype="float32")
    with pytest.raises(ValueError, match="weights"):
        if bound[0] == "fourier":
            pp.apply(*tin, torch.ones(L1 + 1))
        elif bound[1] == "fourier":
            pp.apply(*tin, None, torch.ones(L2 + 1))
        else:
            pp.apply(*tin, None, None, torch.ones(Lout + 1))


# --------------------------------------------------------------------------
# models: the resident path is numerically the non-resident one
# --------------------------------------------------------------------------

CFG_SEGNN = dict(name="t", kind="segnn", L=1, L_edge=1, channels=4, n_layers=2)


def _segnn(seed, **kw):
    from repro.configs.gaunt_ff import EquivariantConfig as RefCfg
    from repro.models.equivariant import SegnnNBody as RefSegnn

    ref = RefSegnn(RefCfg(**CFG_SEGNN, **kw))
    params = ref.init(jax.random.PRNGKey(seed))
    model = SegnnNBody(EquivariantConfig(**CFG_SEGNN, **kw), device="cpu")
    model.load_state_dict(segnn_params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, params, model


def _system(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in ((n,), (n, 3), (n, 3)))


def test_segnn_resident_matches_nonresident():
    """The resident forward converts the edge filter once for the whole
    stack: n_layers x-side conversions + 1, and n_layers projections — the
    reference's count on the same system; the outputs match the
    non-resident route and the reference."""
    ref, params, on = _segnn(0)
    off = SegnnNBody(EquivariantConfig(**CFG_SEGNN, fourier_resident=False), device="cpu")
    off.load_state_dict(on.state_dict())
    sysm = _system(5, 50)
    t = [torch.as_tensor(a) for a in sysm]
    out_on, out_off = on(*t), off(*t)
    _close(out_on, out_off.detach().numpy(), 1e-4)
    n_layers = CFG_SEGNN["n_layers"]
    assert _count(lambda: on(*t)) == (n_layers + 1, n_layers)
    with ref_rep.conversion_stats(fresh=True) as c:
        want = ref.forward(params, *(jnp.asarray(a) for a in sysm))
    assert (c["sh_to_fourier"], c["fourier_to_sh"]) == (n_layers + 1, n_layers)
    assert_close(out_on.detach().numpy(), np.asarray(want), dtype="float32")


def test_selfmix_layer_resident_matches_batched():
    from repro.models.equivariant import SelfmixLayer as RefSelfmix

    L, C = 2, 3
    x = _rand((6, C, num_coeffs(L)), 60)
    ref = RefSelfmix(L=L, channels=C, tp_impl="gaunt")
    params = jax.tree.map(lambda a: a * (1 + 0.1 * jnp.arange(a.size).reshape(a.shape)),
                          ref.init(jax.random.PRNGKey(1)))
    sd = selfmix_params_from_jax(jax.tree.map(np.asarray, params))
    on = SelfmixLayer(L, C, device="cpu")
    off = SelfmixLayer(L, C, resident=False, device="cpu")
    on.load_state_dict(sd)
    off.load_state_dict(sd)
    _close(on(x), off(x).detach().numpy(), 1e-4)
    assert _count(lambda: on(x))[0] == 1  # shared operand: one conversion
    assert_close(on(x).detach().numpy(), np.asarray(ref(params, jnp.asarray(x.numpy()))),
                 dtype="float32")


# --------------------------------------------------------------------------
# grid-resident gates
# --------------------------------------------------------------------------


def _gate_params(C, seed):
    rng = np.random.default_rng(seed)
    return {"w1": torch.as_tensor(rng.normal(size=(C, 16)).astype(np.float32) * 0.3),
            "w2": torch.as_tensor(rng.normal(size=(16, C)).astype(np.float32) * 0.3)}


def test_grid_gate_region_single_entry_exit_pair():
    """A TP -> gate -> selfmix layer as one grid-resident region: the gated
    TP exits resident, the selfmix re-enters for free (2 entries + 1 exit);
    the SH-side gate pays a full extra exit/entry pair."""
    L, B, C = 1, 4, 3
    Ltot = 2 * L
    x1, x2 = _rand((B, C, num_coeffs(L)), 500), _rand((B, C, num_coeffs(L)), 501)
    gp = _gate_params(C, 502)
    tp_g = engine.plan_chain((L, L), Ltot, backend="tree", gate=True)
    tp = engine.plan_chain((L, L), Ltot, backend="tree")
    mix = engine.plan_chain((Ltot, Ltot), Ltot, backend="tree")

    def grid_region():
        mid = tp_g.apply([x1, x2], out_basis="fourier", gate_params=gp)
        return mix.apply([mid, mid])

    def sh_region():
        y = _gate_sh(gp, tp.apply([x1, x2]))
        return mix.apply([y, y])

    assert _count(grid_region) == (2, 1)
    assert _count(sh_region) == (3, 2)
    _close(grid_region(), sh_region().numpy(), 1e-4)


def test_selfmix_gate_params_matches_gate_apply():
    """manybody_selfmix(gate_params=...) == the SH gate on the ungated
    self-product: the fused stage is exact."""
    L, nu, B, C = 2, 3, 4, 3
    x = _rand((B, C, num_coeffs(L)), 510)
    gp = _gate_params(C, 511)
    want = _gate_sh(gp, manybody_selfmix(x, L, nu, Lout=L))
    _close(manybody_selfmix(x, L, nu, Lout=L, gate_params=gp), want.numpy(), 1e-5)


def test_mace_grid_gate_one_conversion_pair_per_layer():
    """A MaceGaunt layer with grid_gate='on' runs its gated many-body region
    with one entry and one exit: the gate adds no conversion over the
    ungated model (the eSCN conv pays its own pair); with identity mb_mix
    the reordered gate coincides with the SH one."""
    kw = dict(name="t", kind="mace", L=1, L_edge=1, channels=5, n_layers=1, nu=3)
    on = MaceGaunt(EquivariantConfig(**kw, grid_gate="on"), device="cpu")
    off = MaceGaunt(EquivariantConfig(**kw), device="cpu")
    off.load_state_dict(on.state_dict())
    rng = np.random.default_rng(520)
    sp = torch.as_tensor(rng.integers(0, 8, size=(4,)))
    pos = torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32) * 1.5)
    c_on = _count(lambda: on.features(sp, pos))
    assert c_on == _count(lambda: off.features(sp, pos)) == (2, 2)  # conv (1,1) + chain (1,1)
    with torch.no_grad():
        for m in (on, off):
            for lp in m.layers:
                lp.mb_mix.copy_(torch.eye(5).expand(2, 5, 5))
    _close(on.features(sp, pos), off.features(sp, pos).detach().numpy(), 1e-5)


def test_segnn_grid_gate_quad_path_matches_off():
    """SEGNN's post-mix gate on the S^2 quadrature grid: one sh_to_quad /
    quad_to_sh pair per layer, as in the reference, and the same output."""
    ref, params, on = _segnn(4, grid_gate="on")
    off = SegnnNBody(EquivariantConfig(**CFG_SEGNN), device="cpu")
    off.load_state_dict(on.state_dict())
    t = [torch.as_tensor(a) for a in _system(5, 530)]
    with rep.conversion_stats(fresh=True) as c:
        out_on = on(*t)
    assert c["sh_to_quad"] == c["quad_to_sh"] == CFG_SEGNN["n_layers"]
    with ref_rep.conversion_stats(fresh=True) as rc:
        ref.forward(params, *(jnp.asarray(a.numpy()) for a in t))
    assert (rc["sh_to_quad"], rc["quad_to_sh"]) == (c["sh_to_quad"], c["quad_to_sh"])
    _close(out_on, off(*t).detach().numpy(), 1e-5)


def test_resolve_grid_gate_policy():
    cfg = EquivariantConfig(name="t", kind="mace", L=1, channels=4)
    Ls = (1, 1, 1)
    assert _resolve_grid_gate(cfg, Ls, 1) is False
    assert _resolve_grid_gate(dataclasses.replace(cfg, grid_gate="on"), Ls, 1) is True
    # 'auto' without measured tuning stays off (no silent timing runs)
    assert _resolve_grid_gate(dataclasses.replace(cfg, grid_gate="auto"), Ls, 1) is False
    with pytest.raises(ValueError, match="grid_gate"):
        _resolve_grid_gate(dataclasses.replace(cfg, grid_gate="bogus"), Ls, 1)


# --------------------------------------------------------------------------
# Rep semantics
# --------------------------------------------------------------------------


def test_rep_resize_round_trip_and_forms():
    L = 2
    x = _rand((3, num_coeffs(L)), 80)
    for form in ("dense", "half"):
        r = Rep.from_sh(x, L).to_fourier("dense", form=form)
        back = r.resize(L + 2).resize(L).to_sh().data
        _close(back, x.numpy(), 2e-5)
        assert r.resize(L + 2).grid("dense").shape[-2:] == (2 * L + 5, 2 * L + 5)
    ref = ref_rep.Rep.from_sh(jnp.asarray(x.numpy()), L).to_fourier("dense").resize(L + 1)
    got = Rep.from_sh(x, L).to_fourier("dense").resize(L + 1)
    assert_close(np.stack([got.data.real, got.data.imag]),
                 np.stack([np.asarray(ref.data).real, np.asarray(ref.data).imag]),
                 dtype="float32")


def test_rep_add_and_errors():
    L = 1
    a = Rep.from_sh(_rand((2, 4), 90), L).to_fourier("dense")
    b = Rep.from_sh(_rand((2, 4), 91), L).to_fourier("half")
    assert (a + b).to_sh().L == L
    with pytest.raises(ValueError):
        Rep.from_sh(_rand((2, 4), 92), L).resize(2)
    with pytest.raises(ValueError):
        a + Rep.from_sh(_rand((2, 4), 93), L)
    with pytest.raises(ValueError):
        engine.plan(1, 1, 1, backend="fft", options={"boundary": ("sh", "sh", "fourier")},
                    device="cpu")
    with pytest.raises(ValueError):
        engine.plan(1, 1, 2, backend="dense_einsum",
                    options={"boundary": ("sh", "fourier", "sh")}, device="cpu")


def test_rep_sdtype_tag_round_trip():
    """A bf16 activation keeps its storage tag across a Fourier round trip
    and exits at bf16, as the reference's Rep does."""
    x = _rand((3, 4), 94).to(torch.bfloat16)
    r = Rep.from_sh(x, 1).to_fourier("half")
    assert r.sdtype == "bfloat16" and r.data.dtype == torch.complex64
    back = r.to_sh()
    assert back.data.dtype == torch.bfloat16 and back.sdtype == "bfloat16"
    assert Rep.from_sh(x, 1).astype("float32").sdtype == "float32"


def test_chain_rejects_weighted_resident_operand():
    L = 1
    x = _rand((2, 4), 95)
    r = Rep.from_sh(x, L).to_fourier("dense")
    for backend in ("tree", "fused_torch"):
        with pytest.raises(ValueError):
            engine.plan_chain((L, L), Lout=L, backend=backend).apply(
                [r, x], weights=[_rand((2, 2), 96), None])


# --------------------------------------------------------------------------
# resident operands and results through the batched layout
# --------------------------------------------------------------------------

_RES_ITEM = engine.BatchItem(L1=2, L2=2, Lout=2, options=(("boundary", ("sh", "fourier", "sh")),))


@pytest.mark.parametrize("backend,form", [("fft", "dense"), ("rfft", "half")])
def test_resident_bucket_matches_per_plan(backend, form):
    L = 2
    x = torch.as_tensor(random_irreps(L, (10,), seed=10))
    f = torch.as_tensor(random_irreps(L, (10,), seed=11))
    bp = engine.plan_batch([_RES_ITEM], backend=backend, requires_grad=False, pad_to=16,
                           device="cpu")
    got = bp.apply([(x, Rep.from_sh(f, L).to_fourier("dense", form=form))])[0]
    ref = engine.plan(L, L, L, backend=backend, requires_grad=False, device="cpu").apply(x, f)
    _close(got, ref.numpy(), 1e-4)


def test_resident_bucket_broadcast_inner_dims():
    """The SEGNN layout: one resident edge filter against C channel
    features; the filter's grid keeps its size-1 channel dim."""
    n, C, L = 3, 4, 1
    x = torch.as_tensor(random_irreps(L, (n, n, C), seed=20))
    f = torch.as_tensor(random_irreps(L, (n, n, 1), seed=21))
    item = engine.BatchItem(L1=L, L2=L, Lout=L, options=(("boundary", ("sh", "fourier", "sh")),))
    bp = engine.plan_batch([item], backend="fft", requires_grad=False, device="cpu")
    got = bp.apply([(x, Rep.from_sh(f, L).to_fourier("dense"))])[0]
    assert got.shape == (n, n, C, num_coeffs(L))
    ref = engine.plan(L, L, L, backend="fft", requires_grad=False, device="cpu").apply(x, f)
    _close(got, ref.numpy(), 1e-4)


def test_resident_output_bucket_returns_reps():
    L = 1
    items = [engine.BatchItem(L1=L, L2=L, Lout=2 * L,
                              options=(("boundary", ("sh", "sh", "fourier")),))] * 2
    bp = engine.plan_batch(items, backend="fft", requires_grad=False, device="cpu")
    ins = [(torch.as_tensor(random_irreps(L, (4,), seed=30 + i)),
            torch.as_tensor(random_irreps(L, (4,), seed=35 + i))) for i in range(2)]
    p = engine.plan(L, L, 2 * L, backend="fft", requires_grad=False, device="cpu")
    for (x1, x2), got in zip(ins, bp.apply(ins)):
        assert isinstance(got, Rep) and got.is_fourier
        _close(got.to_sh().data, p.apply(x1, x2).numpy(), 1e-4)


def test_wigner_geometry_bucket_matches_raw_rhat():
    """Precomputed WignerBlocks through an escn bucket == the per-call
    alignment, weights included."""
    L = 2
    conv = EquivariantConv(L, L, L)
    x = torch.as_tensor(random_irreps(L, (9,), seed=50))
    r = torch.as_tensor(random_unit_vectors((9,), seed=51))
    w1 = torch.as_tensor(random_array((9, L + 1), seed=52))
    geom = conv.geometry_rep(r)
    assert isinstance(geom, WignerBlocks) and geom.L == L
    _close(conv(x, geom, w1=w1), conv(x, r, w1=w1).numpy(), 1e-4)
    item = engine.BatchItem(L1=L, L2=L, Lout=L, options=(("geometry", "wigner"),))
    bp = engine.plan_batch([item, item], kind="conv_filter", backend="escn_aligned",
                           device="cpu", pad_to=8)
    outs = bp.apply([(x, geom), (x[:4], WignerBlocks(tuple(b[:4] for b in geom.blocks)))],
                    weights=[(w1, None, None), (w1[:4], None, None)])
    _close(outs[0], conv(x, r, w1=w1).numpy(), 1e-4)
    _close(outs[1], conv(x[:4], r[:4], w1=w1[:4]).numpy(), 1e-4)


def test_chain_dedups_rep_wrappers():
    """Two Rep wrappers around one grid enter as grids: no conversion, and
    the product equals the SH chain's."""
    L = 1
    x = torch.as_tensor(random_irreps(L, (4,), seed=70))
    r1 = Rep.from_sh(x, L).to_fourier("half")
    alias = Rep(r1.data, r1.L, r1.basis, r1.form)
    cp = engine.plan_chain((L, L), 2 * L)
    assert _count(lambda: cp.apply([r1, alias], out_basis="fourier")) == (0, 0)
    _close(cp.apply([r1, alias], out_basis="fourier").to_sh().data,
           cp.apply([x, x]).numpy(), 1e-4)


def test_bucket_rejects_mixed_rep_and_array_items():
    L = 1
    item = engine.BatchItem(L1=L, L2=L, Lout=L, options=(("boundary", ("sh", "fourier", "sh")),))
    bp = engine.plan_batch([item, item], backend="fft", requires_grad=False, device="cpu")
    x = torch.as_tensor(random_irreps(L, (3,), seed=80))
    f = torch.as_tensor(random_irreps(L, (3,), seed=81))
    with pytest.raises(ValueError, match="operand structure"):
        bp.apply([(x, Rep.from_sh(f, L).to_fourier("dense")), (x, f)])
