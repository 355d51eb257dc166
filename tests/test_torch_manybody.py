"""The port's many-body products against the reference: the ``manybody``
plan kind on each backend (twins of tests/test_engine.py's and
tests/test_engine_transforms.py's manybody tests, forward and gradients),
`plan_batch` manybody buckets == per-plan calls, the rotation equivariance
of tests/test_equivariance.py, `manybody_gaunt_product` on every route
(tests/test_conv_manybody.py), the chain plan's ``conversion`` / ``conv``
/ ``tree`` options against the reference's `plan_chain`, and the cost
model's calibration (`calibrate_fused`: per dtype, isolated between
engines, persisted and reloaded measured).

Tolerances: the f32 identity tier (3e-4) forward and the loose tier (2e-3)
for gradients and rotations, scale-relative (`repro_torch.testing`);
batched == per-plan at 1e-6, as the reference holds it."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.manybody import manybody_gaunt_product as ref_manybody
from repro_torch.core import engine
from repro_torch.core.cg import gaunt_einsum_reference
from repro_torch.core.irreps import num_coeffs
from repro_torch.core.manybody import manybody_gaunt_product, manybody_selfmix
from repro_torch.core.rep import Rep
from repro_torch.testing import (assert_close, random_angles, random_array, random_irreps,
                                 wigner_D)

CPU = "cpu"
MANYBODY = ["dense_einsum", "fft", "direct", "packed", "rfft"]


@pytest.fixture(autouse=True)
def fresh_calibration(monkeypatch):
    """Each test sees both cost models at their defaults and both engines
    with no cached plan (the reference's plan cache keeps a pick made under
    another test's calibration), and a calibration made here does not
    outlive the test."""
    monkeypatch.setattr(engine, "_CALIB", dict(engine._CALIB_DEFAULTS))
    ref_engine.get_engine().clear()
    engine.get_engine().clear()
    yield
    ref_engine.get_engine().clear()
    engine.get_engine().clear()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _xs(L, n, lead=(4,), seed=20):
    return [random_irreps(L, lead, seed=seed + i) for i in range(n)]


# --------------------------------------------------------------------------
# the manybody plan kind
# --------------------------------------------------------------------------


def test_manybody_registry_and_heuristic_match_reference():
    assert engine.available_backends("manybody") == \
        ref_engine.available_backends("manybody") == MANYBODY
    eng, ref = engine.GauntEngine(), ref_engine.GauntEngine()
    for Ls, Lout in (((2, 2, 2), 2), ((1, 1), 2), ((3, 2, 2, 1), 4), ((6, 6), 6)):
        for B in (1, 64, 4096, 81920):
            extra = (("Ls", Ls),)
            pk = engine.PlanKey(max(Ls), min(Ls), Lout, "manybody", B, "float32", extra, CPU)
            rk = ref_engine.PlanKey(max(Ls), min(Ls), Lout, "manybody", B, "float32", extra)
            assert eng.select(pk) == ref.select(rk), (Ls, B)


@pytest.mark.parametrize("backend", MANYBODY)
def test_manybody_backends_match_reference_forward_and_gradients(backend):
    """The plan on each backend against the reference's plan and the fold of
    dense Gaunt products; gradients of sum(out^2) with respect to every
    operand; a stacked batch of two equals the two calls (the vmap of the
    reference's test)."""
    L, nu = 2, 3
    xs = _xs(L, nu)
    p = engine.plan(kind="manybody", Ls=(L,) * nu, Lout=L, backend=backend, device=CPU)
    rp = ref_engine.plan(kind="manybody", Ls=(L,) * nu, Lout=L, backend=backend)
    assert p.backend == backend and p.key.opt("Ls") == (L,) * nu
    txs = [_t(x).requires_grad_(True) for x in xs]
    out = p.apply(txs)
    assert_close(out.detach(), np.asarray(rp.apply([_j(x) for x in xs])), dtype="float32")
    fold = gaunt_einsum_reference(gaunt_einsum_reference(_t(xs[0]), _t(xs[1]), L, L),
                                  _t(xs[2]), 2 * L, L, L)
    np.testing.assert_allclose(out.detach().numpy(), fold.numpy(), atol=1e-3)
    got = torch.autograd.grad((out ** 2).sum(), txs)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(rp.apply(list(a)) ** 2),
                            argnums=tuple(range(nu))))(*[_j(x) for x in xs])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_close(g, np.asarray(w), dtype="float32", tier="loose")
    stacked = p.apply([torch.stack([_t(x), 2 * _t(x)]) for x in xs])
    np.testing.assert_allclose(stacked[0].numpy(), out.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", MANYBODY)
def test_manybody_weights_and_truncation_match_reference(backend):
    Ls, Lout = (2, 1, 2), 3
    xs = [random_irreps(L, (5,), seed=30 + i) for i, L in enumerate(Ls)]
    ws = [random_array((5, L + 1), 40 + i) for i, L in enumerate(Ls)]
    p = engine.plan(kind="manybody", Ls=Ls, Lout=Lout, backend=backend, device=CPU)
    rp = ref_engine.plan(kind="manybody", Ls=Ls, Lout=Lout, backend=backend)
    got = p.apply([_t(x) for x in xs], [_t(w) for w in ws])
    assert got.shape == (5, num_coeffs(Lout))
    assert_close(got, np.asarray(rp.apply([_j(x) for x in xs], [_j(w) for w in ws])),
                 dtype="float32")


@pytest.mark.parametrize("backend", MANYBODY)
def test_plan_batch_manybody_matches_per_plan(backend):
    """Two Ls buckets and a ragged item: each bucket is one call, equal to
    per-plan calls (1e-6) and to the reference's buckets."""
    items = [engine.BatchItem(Ls=(2, 2, 2), Lout=2), engine.BatchItem(Ls=(1, 2)),
             engine.BatchItem(Ls=(2, 2, 2), Lout=2)]
    bp = engine.plan_batch(items, kind="manybody", backend=backend, requires_grad=False,
                           device=CPU)
    assert len(bp.buckets) == 2 and [b.item_ids for b in bp.buckets] == [(0, 2), (1,)]
    ins = [_xs(2, 3, (5,), 60), [random_irreps(1, (3,), 70), random_irreps(2, (3,), 71)],
           _xs(2, 3, (2, 3), 80)]
    ws = [None, None, [random_array((2, 3, 3), 90 + i) for i in range(3)]]
    got = bp.apply([[_t(x) for x in xs] for xs in ins],
                   [None if w is None else [_t(a) for a in w] for w in ws])
    rbp = ref_engine.plan_batch([ref_engine.BatchItem(Ls=it.Ls, Lout=it.Lout) for it in items],
                                kind="manybody", backend=backend, requires_grad=False)
    want = rbp.apply([[_j(x) for x in xs] for xs in ins],
                     [None if w is None else [_j(a) for a in w] for w in ws])
    for i, it in enumerate(items):
        p = engine.plan(kind="manybody", Ls=it.Ls, Lout=it.Lout, backend=backend,
                        requires_grad=False, device=CPU)
        per = p.apply([_t(x) for x in ins[i]], None if ws[i] is None else [_t(a) for a in ws[i]])
        assert got[i].shape == per.shape
        np.testing.assert_allclose(got[i].numpy(), per.numpy(), rtol=1e-6, atol=1e-6)
        assert_close(got[i], np.asarray(want[i]), dtype="float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("backend", MANYBODY)
def test_manybody_rotation_equivariance(backend, L, dtype):
    nu = 3
    angles = random_angles(seed=40 + L)
    xs = [random_irreps(L, (4,), seed=50 + L + i) for i in range(nu)]
    D = wigner_D(L, angles)
    p = engine.plan(kind="manybody", Ls=(L,) * nu, Lout=L, backend=backend,
                    requires_grad=False, dtype=dtype, device=CPU)
    dt = getattr(torch, dtype)
    lhs = p.apply([_t(x @ D.T).to(dt) for x in xs]).double().numpy()
    rhs = p.apply([_t(x).to(dt) for x in xs]).double().numpy() @ D.T
    assert_close(lhs, rhs, dtype=dtype, tier="loose")


def test_manybody_auto_dtype_and_measure_on_the_cpu():
    """A measured manybody key times the eligible backends once and is
    cached; 'auto' resolves to a storage dtype the way plans do."""
    eng = engine.GauntEngine()
    p = eng.plan(kind="manybody", Ls=(1, 1, 1), Lout=1, batch_hint=32, tune="measure",
                 device=CPU)
    assert p.backend in MANYBODY and eng.timing_runs == 1
    assert set(eng.measured_times[p.key]) == set(MANYBODY)
    assert eng.plan(kind="manybody", Ls=(1, 1, 1), Lout=1, batch_hint=32, tune="measure",
                    device=CPU) is p
    pa = eng.plan(kind="manybody", Ls=(1, 1, 1), Lout=1, batch_hint=32, tune="measure",
                  dtype="auto", device=CPU)
    assert pa.key.dtype in ("float32", "bfloat16")
    with pytest.raises(ValueError, match="Ls"):
        eng.plan(kind="manybody", Ls=(2,), device=CPU)
    with pytest.raises(ValueError, match="selection rule"):
        eng.plan(kind="manybody", Ls=(1, 1), Lout=3, device=CPU)
    with pytest.raises(ValueError, match="cannot serve"):
        eng.plan(kind="manybody", Ls=(1, 1), backend="fused_torch", device=CPU)


# --------------------------------------------------------------------------
# manybody_gaunt_product on every route
# --------------------------------------------------------------------------


def test_manybody_matches_fold():
    L, nu = 2, 3
    xs = [_t(x) for x in _xs(L, nu)]
    got = manybody_gaunt_product(xs, [L] * nu)
    acc = gaunt_einsum_reference(gaunt_einsum_reference(xs[0], xs[1], L, L), xs[2], 2 * L, L)
    np.testing.assert_allclose(got.numpy(), acc.numpy(), atol=1e-3)


def test_manybody_four_operands_batched_tree():
    L = 1
    xs = [_t(x) for x in _xs(L, 4, (3,), 30)]
    got = manybody_gaunt_product(xs, [L] * 4)
    acc = gaunt_einsum_reference(xs[0], xs[1], L, L)
    acc = gaunt_einsum_reference(acc, xs[2], 2 * L, L)
    acc = gaunt_einsum_reference(acc, xs[3], 3 * L, L)
    np.testing.assert_allclose(got.numpy(), acc.numpy(), atol=1e-3)


def test_manybody_truncated_output_and_weights():
    L, nu, Lout = 2, 3, 2
    x = _t(random_irreps(L, (5,), 40))
    got = manybody_selfmix(x, L, nu, Lout=Lout)
    acc = gaunt_einsum_reference(gaunt_einsum_reference(x, x, L, L), x, 2 * L, L, Lout)
    np.testing.assert_allclose(got.numpy(), acc.numpy(), atol=1e-3)
    assert got.shape == (5, num_coeffs(Lout))
    from repro_torch.core.gaunt import expand_degree_weights

    w = [_t(random_array((5, L + 1), 42 + i)) for i in range(2)]
    got = manybody_gaunt_product([x, x], [L, L], weights=w)
    want = gaunt_einsum_reference(x * expand_degree_weights(w[0], L),
                                  x * expand_degree_weights(w[1], L), L, L)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


@pytest.mark.parametrize("route", [
    dict(), dict(conversion="dense"), dict(conversion="dense", conv="fft"),
    dict(conversion="half", conv="direct"), dict(conversion="packed"),
    dict(conversion="packed", conv="direct"), dict(backend="auto"), dict(backend="rfft"),
    dict(backend="dense_einsum", dtype="bfloat16")])
def test_manybody_gaunt_product_routes_match_reference(route):
    Ls = (2, 1, 2)
    xs = [random_irreps(L, (4,), seed=100 + i) for i, L in enumerate(Ls)]
    ws = [random_array((4, L + 1), 110 + i) for i, L in enumerate(Ls)]
    want = ref_manybody([_j(x) for x in xs], Ls, Lout=3, weights=[_j(w) for w in ws],
                        **route)
    got = manybody_gaunt_product([_t(x) for x in xs], Ls, Lout=3,
                                 weights=[_t(w) for w in ws], **route)
    dtype = route.get("dtype", "float32")
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, np.asarray(want).astype(np.float64), dtype=dtype)
    out = manybody_gaunt_product([_t(x) for x in xs], Ls, Lout=3, rdtype=torch.float64,
                                 **route)
    assert out.dtype == torch.float64


def test_manybody_gaunt_product_float64_from_cdtype():
    """dtype=None is the storage cdtype implies: complex128 -> float64,
    held against the float64 oracle at the f64 identity tier."""
    L = 2
    xs = [_t(x).double() for x in _xs(L, 3, (3,), 120)]
    got = manybody_gaunt_product(xs, [L] * 3, Lout=L, cdtype=torch.complex128)
    assert got.dtype == torch.float64
    fold = gaunt_einsum_reference(gaunt_einsum_reference(xs[0], xs[1], L, L), xs[2],
                                  2 * L, L, L)
    assert_close(got, fold, dtype="float64")


def test_manybody_gaunt_product_rejects_what_its_route_cannot_do():
    x = _t(random_irreps(1, (3,), 1))
    with pytest.raises(ValueError, match="shard mode"):
        manybody_gaunt_product([x, x], [1, 1], shard_spec=engine.ShardSpec(mode="nope"))
    # a spec with no mesh runs unsharded, on either route
    for kw in ({}, {"conversion": "packed"}):
        assert_close(manybody_gaunt_product([x, x], [1, 1], shard_spec=engine.ShardSpec(), **kw),
                     manybody_gaunt_product([x, x], [1, 1], **kw), dtype="float32")
    gp = {"w1": torch.ones(1, 2), "w2": torch.ones(2, 1)}
    with pytest.raises(ValueError, match="chain route"):
        manybody_gaunt_product([x, x], [1, 1], backend="fft", gate_params=gp)
    with pytest.raises(ValueError, match="chain route"):
        manybody_gaunt_product([x, x], [1, 1], conversion="packed", out_basis="fourier")
    with pytest.raises(ValueError, match="conversion"):
        manybody_gaunt_product([x, x], [1, 1], conversion="nope")


def test_manybody_measured_chain_route_keys_as_before():
    """Under tune='measure' the chain route keys all-SH operands exactly as
    before (no bases in the key), and resident operands with their bases."""
    eng = engine.get_engine()
    x = _t(random_irreps(1, (16,), 3))
    manybody_selfmix(x, 1, 3, Lout=1, tune="measure")
    key = eng.chain_measure_key((1, 1, 1), 1, "float32", 16, (0, 0, 0), False, CPU)
    assert len(key) == 7 and eng.measured_pick(key) is not None
    r = Rep.from_sh(_t(random_irreps(1, (16,), 4)), 1).to_fourier("half")
    manybody_gaunt_product([x, r], [1, 1], tune="measure")
    rkey = eng.chain_measure_key((1, 1), 2, "float32", 16, (0, 1), False, CPU,
                                 ("sh", "fourier"), "sh")
    assert eng.measured_pick(rkey) is not None


# --------------------------------------------------------------------------
# the chain plan's spectral options
# --------------------------------------------------------------------------

CHAIN_OPTIONS = [("half", "rfft", False), ("half", "direct", True), ("dense", "fft", True),
                 ("dense", "direct", False)]


@pytest.mark.parametrize("conversion,conv,tree", CHAIN_OPTIONS)
@pytest.mark.parametrize("Ls", [(2, 2), (1, 2, 2, 1)])
def test_chain_options_match_reference(Ls, conversion, conv, tree):
    """conversion, conv and tree against the reference's plan_chain, on a
    shared operand under different weights (one degree-resolved
    conversion), with a resident operand, and with a resident exit."""
    n = len(Ls)
    Lout = max(Ls)
    xs = [random_irreps(L, (3,), seed=200 + i) for i, L in enumerate(Ls)]
    xs[1] = xs[0] if Ls[0] == Ls[1] else xs[1]
    ws = [random_array((3, L + 1), 210 + i) for i, L in enumerate(Ls)]
    kw = dict(conversion=conversion, conv=conv, tree=tree)
    cp = engine.plan_chain(Ls, Lout, device=CPU, **kw)
    rcp = ref_engine.plan_chain(Ls, Lout, **kw)
    assert (cp.backend, cp.conversion, cp.conv, cp.tree) == \
        (rcp.backend, rcp.conversion, rcp.conv, rcp.tree) == ("tree", conversion, conv, tree)
    tx = [_t(x) for x in xs]
    tx[1] = tx[0] if xs[1] is xs[0] else tx[1]
    got = cp.apply(tx, weights=[_t(w) for w in ws])
    jx = [_j(x) for x in xs]
    jx[1] = jx[0] if xs[1] is xs[0] else jx[1]
    want = rcp.apply(jx, weights=[_j(w) for w in ws])
    assert_close(got, np.asarray(want), dtype="float32")
    # a resident entry and a resident exit
    r0 = Rep.from_sh(tx[0], Ls[0]).to_fourier(conversion)
    full = engine.plan_chain(Ls, sum(Ls), device=CPU, **kw)
    res = full.apply([r0] + tx[1:], out_basis="fourier")
    assert res.is_fourier and res.form == ("half" if conversion == "half" else "dense")
    ref_full = ref_engine.plan_chain(Ls, sum(Ls), **kw)
    from repro.core.rep import Rep as RefRep

    rr0 = RefRep.from_sh(jx[0], Ls[0]).to_fourier(conversion)
    rres = ref_full.apply([rr0] + jx[1:], out_basis="fourier")
    assert_close(res.to_sh(Lout).data, np.asarray(rres.to_sh(Lout).data), dtype="float32")
    assert n == len(cp.Ls)


def test_chain_default_conv_follows_the_reference_rule():
    for Ls in ((2, 2), (4, 4), (5, 1), (2, 2, 2), (1, 1, 1, 1)):
        cp, rcp = engine.plan_chain(Ls, device=CPU), ref_engine.plan_chain(Ls)
        assert (cp.conversion, cp.conv) == (rcp.conversion, rcp.conv), Ls
        dense = engine.plan_chain(Ls, conversion="dense", device=CPU)
        assert dense.conv == ref_engine.plan_chain(Ls, conversion="dense").conv
    assert engine.plan_chain((2, 2), device=CPU).conv == "direct"
    assert engine.plan_chain((2, 2, 2), device=CPU).conv == "rfft"
    with pytest.raises(ValueError, match="half grids"):
        engine.plan_chain((2, 2), conversion="dense", conv="rfft", device=CPU)
    with pytest.raises(ValueError, match="conversion"):
        engine.plan_chain((2, 2), conversion="packed", device=CPU)
    with pytest.raises(ValueError, match="shard mode"):
        engine.plan_chain((2, 2), shard_spec=engine.ShardSpec(mode="nope"), device=CPU)
    # with no mesh the spec is inert: the unsharded plan itself
    assert engine.plan_chain((2, 2), shard_spec=engine.ShardSpec(), device=CPU) \
        is engine.plan_chain((2, 2), device=CPU)


def test_chain_options_pin_tree_and_key_the_plan_cache_only():
    """An explicit conversion or conv pins 'tree' without timing; the
    options key the plan cache (distinct plans) and leave the measured key
    as it was; donate is accepted and donates nothing."""
    eng = engine.GauntEngine()
    p = eng.plan_chain((1, 1, 1), 1, conversion="dense", tune="measure", batch_hint=32,
                       device=CPU)
    assert p.backend == "tree" and eng.timing_runs == 0
    a = eng.plan_chain((1, 1, 1), 1, device=CPU)
    b = eng.plan_chain((1, 1, 1), 1, tree=False, device=CPU)
    c = eng.plan_chain((1, 1, 1), 1, conv="fft", device=CPU)
    assert len({id(a), id(b), id(c), id(p)}) == 4
    assert eng.plan_chain((1, 1, 1), 1, device=CPU) is a
    d = eng.plan_chain((1, 1, 1), 1, donate=True, device=CPU)
    assert d is a
    x = _t(random_irreps(1, (4,), 9))
    keep = x.clone()
    out = d.apply([x, x, x])
    assert torch.equal(x, keep)
    np.testing.assert_allclose(out.numpy(), a.apply([x, x, x]).numpy(), atol=1e-6)
    key = eng.chain_measure_key((1, 1, 1), 1, "float32", 32, None, False, CPU)
    assert key == ((1, 1, 1), 1, "float32", 32, (0, 1, 2), False, "cpu")


def test_gated_dense_resident_exit_equals_half():
    """The gate on a resident exit: a dense grid gates as its half form."""
    Ls = (1, 1)
    gp = {"w1": _t(random_array((3, 4), 1)), "w2": _t(random_array((4, 3), 2))}
    xs = [_t(random_irreps(1, (3,), 3 + i)) for i in range(2)]
    outs = [engine.plan_chain(Ls, 2, conversion=c, gate=True, device=CPU).apply(
        xs, out_basis="fourier", gate_params=gp) for c in ("half", "dense")]
    assert outs[1].form == "dense"
    np.testing.assert_allclose(outs[1].with_form("half").data.numpy(), outs[0].data.numpy(),
                               atol=1e-5)


# --------------------------------------------------------------------------
# calibrate_fused
# --------------------------------------------------------------------------


def test_calibration_is_keyed_by_dtype():
    """calibrate_fused(dtype=...) installs a per-dtype factor as measured
    and leaves the other precisions' entries untouched; the cost model
    reads it; one timing run; the conversion counters are left alone."""
    from repro_torch.core import rep

    base = engine.get_calibration()
    eng = engine.GauntEngine()
    before = dict(rep.conversion_stats())
    rec = eng.calibrate_fused(L=2, B=32, dtype="bfloat16", device=CPU)
    assert dict(rep.conversion_stats()) == before
    assert rec["dtype"] == "bfloat16" and rec["device"] == "cpu" and eng.timing_runs == 1
    assert set(rec) >= {"factor", "fused_torch_us", "dense_einsum_us", "L", "B"}
    cal = engine.get_calibration()
    assert cal["fused_skinny:bfloat16_measured"]
    assert cal["fused_skinny:bfloat16"] == pytest.approx(rec["factor"], rel=1e-2)
    assert 0.25 <= cal["fused_skinny:bfloat16"] <= 16.0
    assert cal["fused_skinny"] == base["fused_skinny"]
    assert cal["fused_skinny_measured"] == base["fused_skinny_measured"]
    k = engine.PlanKey(2, 2, 2, batch_hint=64, dtype="bfloat16", device=CPU)
    assert engine._cost_fused(k, kernel=False) == pytest.approx(
        cal["fused_skinny:bfloat16"] * 64 * 128 * (9 + 9 + 9) + engine._OVERHEAD * 4)
    with pytest.raises(ValueError, match="float64"):
        eng.calibrate_fused(L=2, B=8, dtype="float64", device=CPU)


def test_clear_resets_calibration_so_fresh_engines_rank_identically():
    defaults = engine.get_calibration()
    k = engine.PlanKey(6, 6, 6, kind="pairwise", batch_hint=64, device=CPU)
    fresh = engine.GauntEngine().select(k)
    eng = engine.GauntEngine()
    eng.calibrate_fused(L=2, B=16, device=CPU)
    engine.set_calibration(fused_skinny=16.0, fused_skinny_measured=True)
    assert engine.get_calibration() != defaults
    engine.GauntEngine().clear()
    assert engine.get_calibration() == defaults
    assert engine.GauntEngine().select(k) == fresh


def test_persisted_factor_reloads_measured(tmp_path):
    """A measured factor is flushed to the autotune cache and a fresh
    engine loads it as measured with no timing run; a locally measured
    value is not overwritten by the file."""
    path = str(tmp_path / "cache.json")
    cold = engine.GauntEngine(cache_path=path)
    rec = cold.calibrate_fused(L=2, B=32, device=CPU)
    saved = json.load(open(path))["calibration"]
    assert saved["fused_skinny_measured"] and not saved["fused_skinny:float64_measured"]
    engine.reset_calibration()
    warm = engine.GauntEngine(cache_path=path)
    warm.load_autotune_cache()
    cal = engine.get_calibration()
    assert cal["fused_skinny_measured"] and warm.timing_runs == 0
    assert cal["fused_skinny"] == pytest.approx(rec["factor"], rel=1e-2)
    assert not cal["fused_skinny:float64_measured"]
    engine.reset_calibration()
    engine.set_calibration(fused_skinny=9.5, fused_skinny_measured=True)
    engine.GauntEngine(cache_path=path).load_autotune_cache()
    assert engine.get_calibration()["fused_skinny"] == 9.5
