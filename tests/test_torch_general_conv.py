"""The paper's general equivariant convolution in the port against the
reference — twins of tests/test_conv_manybody.py (general == escn ==
oracle, weights, equivariance), tests/test_resident_chain.py (the filter
converts once across a layer stack; resident == non-resident MaceGaunt)
and tests/test_so3.py (Euler angles) — plus `filter_rep` and
`MaceGaunt(conv_impl='general')` energy, forces and training loss against
the reference at converted parameters, and the constant cache's counters
(tests/test_engine.py).

Inputs are the same numpy arrays on both sides.  Tolerances: the reference
tests' own bounds, and the f32 tiers of `repro_torch.testing.tol_for`
(identity 3e-4, loose 2e-3) against the reference."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gaunt_ff import gaunt_mace_ff as ref_cfg
from repro.core import engine as ref_engine
from repro.core.conv import EquivariantConv as RefConv
from repro.models.equivariant import MaceGaunt as RefMace
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.core import constants, engine, rep, so3
from repro_torch.core.cg import gaunt_einsum_reference
from repro_torch.core.conv import EquivariantConv, WignerBlocks
from repro_torch.core.irreps import num_coeffs
from repro_torch.core.rep import Rep
from repro_torch.data import lj_dataset
from repro_torch.models.convert import params_from_jax
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.testing import (assert_close, random_angles, random_array, random_irreps,
                                 random_unit_vectors, rotation_matrix, wigner_D)

CPU = "cpu"
TO_REF = {"fused_torch": "fused_xla", "fused_hopper": "fused_pallas"}


@pytest.fixture(autouse=True)
def isolated_engines():
    """Each test starts from both engines as fresh: default calibration and
    no cached plan.  Another test of the process may have calibrated the
    reference (its measured factor can reach the 0.25 floor), and the
    reference's plan cache keeps a pick made under that factor even after
    ``reset_calibration()``; ``clear()`` drops both."""
    _fresh_engines()
    yield
    _fresh_engines()


def _fresh_engines():
    ref_engine.get_engine().clear()
    engine.get_engine().clear()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _count(fn):
    """(s2f, f2s) conversions inside ``fn``, scoped and restored."""
    with rep.conversion_stats(fresh=True) as c:
        fn()
    return c["sh_to_fourier"], c["fourier_to_sh"]


# --------------------------------------------------------------------------
# EquivariantConv(method='general' | 'auto')
# --------------------------------------------------------------------------


@pytest.mark.parametrize("L1,L2,Lout", [(2, 2, 4), (3, 2, 3), (2, 3, 5), (1, 4, 5)])
def test_general_conv_matches_escn_oracle_and_reference(L1, L2, Lout):
    x = random_array((16, num_coeffs(L1)), 4)
    r = random_unit_vectors((16,), 5)
    general = EquivariantConv(L1, L2, Lout, method="general", device=CPU)
    escn = EquivariantConv(L1, L2, Lout, method="escn")
    assert general.backend == engine.spectral_default(L1, L2) == "direct"
    filt = so3.real_sph_harm_torch(L2, _t(r))
    oracle = gaunt_einsum_reference(_t(x), filt, L1, L2, Lout)
    got = general(_t(x), _t(r))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=3e-4)
    np.testing.assert_allclose(escn(_t(x), _t(r)).numpy(), oracle.numpy(), atol=3e-4)
    want = RefConv(L1, L2, Lout, method="general")(_j(x), _j(r))
    assert_close(got, np.asarray(want), dtype="float32")


def test_general_conv_weights_match_escn_and_reference():
    L1, L2, Lout = 2, 2, 3
    x = random_array((6, num_coeffs(L1)), 6)
    r = random_unit_vectors((6,), 7)
    ws = [random_array((6, L + 1), 8 + i) for i, L in enumerate((L1, L2, Lout))]
    general = EquivariantConv(L1, L2, Lout, method="general", device=CPU)
    got = general(_t(x), _t(r), *map(_t, ws))
    esc = EquivariantConv(L1, L2, Lout, method="escn")(_t(x), _t(r), *map(_t, ws))
    np.testing.assert_allclose(got.numpy(), esc.numpy(), atol=3e-4)
    want = RefConv(L1, L2, Lout, method="general")(_j(x), _j(r), *map(_j, ws))
    assert_close(got, np.asarray(want), dtype="float32")


@pytest.mark.parametrize("resident", [False, True])
def test_general_conv_equivariance(resident):
    """Rotating the feature and the geometry rotates the output, on raw
    directions and on the resident filter."""
    L1, L2, Lout = 2, 2, 3
    conv = EquivariantConv(L1, L2, Lout, method="general", device=CPU)
    x = random_array((num_coeffs(L1),), seed=11)
    r = np.asarray(random_unit_vectors((), seed=11), np.float64)
    angles = random_angles(seed=11)
    Rg, D1, D3 = rotation_matrix(angles), wigner_D(L1, angles), wigner_D(Lout, angles)

    def run(xv, rv):
        g = _t(rv.astype(np.float32))[None]
        return conv(_t(xv)[None], conv.filter_rep(g) if resident else g)[0].numpy()

    out, out_rot = run(x, r), run(D1 @ x, Rg @ r)
    assert_close(out_rot, D3 @ out, dtype="float32", tier="transform")


def test_auto_conv_selects_and_computes_as_the_reference():
    """method='auto' is the engine's conv_filter selection: the reference's
    pick (under the name map) and its numbers."""
    for L1, L2, Lout, B in ((2, 2, 4, 64), (3, 3, 3, 4096)):
        conv = EquivariantConv(L1, L2, Lout, method="auto", batch_hint=B, device=CPU)
        ref = RefConv(L1, L2, Lout, method="auto", batch_hint=B)
        assert TO_REF.get(conv.backend, conv.backend) == ref.backend
        x = random_array((5, num_coeffs(L1)), 20 + L1)
        r = random_unit_vectors((5,), 21 + L1)
        assert_close(conv(_t(x), _t(r)), np.asarray(ref(_j(x), _j(r))), dtype="float32")


def test_auto_conv_after_a_reference_calibration_at_its_floor():
    """A reference calibration at the 0.25 floor moves its auto pick, and
    its plan cache keeps that pick; the isolation between tests restores
    the pick the port is compared with."""
    ref_engine.set_calibration(fused_skinny=0.25, fused_skinny_measured=True)
    assert RefConv(3, 3, 3, method="auto", batch_hint=4096).backend == "fused_xla"
    _fresh_engines()
    test_auto_conv_selects_and_computes_as_the_reference()


@pytest.mark.parametrize("backend", [None, "fft", "rfft"])
def test_filter_rep_matches_reference(backend):
    """filter_rep: Y(r) (times w2) on a dense grid, or a half grid when the
    spectral backend is rfft; the resident call equals the raw one."""
    L1, L2, Lout = 2, 3, 3
    r = random_unit_vectors((4, 3), 30)
    w2 = random_array((4, 3, L2 + 1), 31)
    x = random_array((4, 3, num_coeffs(L1)), 32)
    conv = EquivariantConv(L1, L2, Lout, method="general", backend=backend, device=CPU)
    ref = RefConv(L1, L2, Lout, method="general", backend=backend)
    got, want = conv.filter_rep(_t(r), _t(w2)), ref.filter_rep(_j(r), _j(w2))
    assert (got.basis, got.form, got.L) == (want.basis, want.form, want.L)
    assert got.form == ("half" if backend == "rfft" else "dense")
    assert_close(got.data.real, np.asarray(want.data).real, dtype="float32")
    assert_close(got.data.imag, np.asarray(want.data).imag, dtype="float32")
    out = conv(_t(x), got)
    assert_close(out, np.asarray(ref(_j(x), want)), dtype="float32")
    assert_close(out, conv(_t(x), _t(r), None, _t(w2)), dtype="float32")


def test_resident_filter_rejects_w2_and_geometry_rep_needs_escn():
    conv = EquivariantConv(2, 2, 2, method="general", device=CPU)
    r = _t(random_unit_vectors((3,), 1))
    x = _t(random_array((3, 9), 2))
    with pytest.raises(ValueError, match="filter_rep"):
        conv(x, conv.filter_rep(r), w2=_t(random_array((3, 3), 3)))
    with pytest.raises(ValueError, match="geometry_rep"):
        conv.geometry_rep(r)
    assert isinstance(EquivariantConv(2, 2, 2).geometry_rep(r), WignerBlocks)
    with pytest.raises(ValueError, match="shard mode"):
        EquivariantConv(2, 2, 2, method="general", shard_spec=engine.ShardSpec(mode="nope"),
                        device=CPU)
    # a spec with no mesh (none given, none registered) runs unsharded
    inert = EquivariantConv(2, 2, 2, method="general", shard_spec=engine.ShardSpec(),
                            device=CPU)
    assert_close(inert(x, r), conv(x, r), dtype="float32")
    with pytest.raises(ValueError, match="unknown method"):
        EquivariantConv(2, 2, 2, method="nope", device=CPU)


def test_general_conv_gradients_match_reference():
    """d(sum(out * W))/d(x, rhat) through the resident filter."""
    L1, L2 = 2, 3
    x = random_array((4, 3, num_coeffs(L1)), 40)
    r = random_unit_vectors((4, 1), 41)
    w1 = random_array((4, 3, L1 + 1), 42)
    W = random_array((4, 3, num_coeffs(L1)), 43)
    ref = RefConv(L1, L2, L1, method="general")

    def ref_loss(x, r):
        return jnp.sum(ref(x, ref.filter_rep(r), w1=_j(w1)) * W)

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(_j(x), _j(r))
    conv = EquivariantConv(L1, L2, L1, method="general", device=CPU)
    tx, tr = _t(x).requires_grad_(True), _t(r).requires_grad_(True)
    out = conv(tx, conv.filter_rep(tr), w1=_t(w1))
    got = torch.autograd.grad((out * _t(W)).sum(), (tx, tr))
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), dtype="float32", tier="loose")


def test_conv_filter_rep_converts_once_across_layers():
    """A layer stack over fixed edge geometry: the filter converts once."""
    L, n_layers = 2, 3
    conv = EquivariantConv(L, L, L, method="general", device=CPU)
    x = _t(random_array((8, num_coeffs(L)), 30))
    r = _t(random_unit_vectors((8,), 31))

    def per_layer():
        for _ in range(n_layers):
            conv.plan.apply(x, r)

    def resident():
        filt = conv.filter_rep(r)
        for _ in range(n_layers):
            conv(x, filt)

    s2f_loop, f2s_loop = _count(per_layer)
    s2f_res, f2s_res = _count(resident)
    assert s2f_loop == 2 * n_layers and f2s_loop == n_layers
    # 1 filter conversion + n_layers x conversions; projections unchanged
    assert s2f_res == n_layers + 1 and f2s_res == n_layers
    np.testing.assert_allclose(conv(x, conv.filter_rep(r)).numpy(), conv(x, r).numpy(),
                               atol=1e-4)


# --------------------------------------------------------------------------
# MaceGaunt(conv_impl='general')
# --------------------------------------------------------------------------

SMALL = dict(channels=4, n_layers=2, L=2, L_edge=3, n_species=4, conv_impl="general")


def _pair(seed=0, **over):
    kw = dict(SMALL, **over)
    ref = RefMace(dataclasses.replace(ref_cfg, **kw))
    params = ref.init(jax.random.PRNGKey(seed))
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **kw), device=CPU)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, params, model


@pytest.fixture(scope="module")
def clusters():
    """LJ clusters of 5 atoms (dense enough that every pair interacts)."""
    return lj_dataset(4, n_atoms=5, n_species=4, seed=3)


@pytest.mark.parametrize("resident", [True, False])
def test_mace_general_energy_forces_match_reference(clusters, resident):
    """Energy at the f32 identity tier; forces at the loose tier relative to
    their own scale (the reference's init gives forces of ~1e-5)."""
    ref, params, model = _pair(fourier_resident=resident)
    sp, pos = clusters["species"][0], clusters["pos"][0]
    e_ref, g_ref = jax.jit(jax.value_and_grad(lambda p: ref.energy(params, _j(sp), p)))(
        _j(pos))
    e, f = model.energy_forces(_t(sp), _t(pos))
    assert_close(e, np.float32(e_ref), dtype="float32")
    f_ref = -np.asarray(g_ref)
    assert float(np.abs(f_ref).max()) > 0
    assert_close(f, f_ref, tol=2e-3 * float(np.abs(f_ref).max()))


def test_mace_general_equals_escn_at_the_same_parameters(clusters):
    """The two convolutions compute one function: a general model and an
    eSCN model with the same state give the same energies and forces."""
    _, _, general = _pair()
    escn = MaceGaunt(dataclasses.replace(general.cfg, conv_impl="escn"), device=CPU)
    escn.load_state_dict(general.state_dict())
    sp, pos = _t(clusters["species"]), _t(clusters["pos"])
    e0, f0 = general.energy_forces(sp, pos)
    e1, f1 = escn.energy_forces(sp, pos)
    assert_close(e0, e1, dtype="float32")
    assert_close(f0, f1, tol=2e-3 * float(f1.abs().max()))


def test_mace_resident_matches_nonresident_general_conv():
    cfg = dataclasses.replace(gaunt_mace_ff, L=1, L_edge=1, channels=4, n_layers=2, nu=3,
                              conv_impl="general")
    rng = np.random.default_rng(70)
    species = torch.as_tensor(rng.integers(0, cfg.n_species, size=(4,)))
    pos = torch.as_tensor(rng.normal(size=(4, 3)) * 1.5, dtype=torch.float32)
    on = MaceGaunt(cfg, device=CPU)
    off = MaceGaunt(dataclasses.replace(cfg, fourier_resident=False), device=CPU)
    off.load_state_dict(on.state_dict())
    with torch.no_grad():
        e_on, e_off = float(on.energy(species, pos)), float(off.energy(species, pos))
    np.testing.assert_allclose(e_on, e_off, rtol=1e-4, atol=1e-4)


def test_mace_general_converts_filter_once_per_geometry(clusters):
    """Across the layer stack the filter converts once: each of the two
    layers adds one x conversion (the conv) and one selfmix entry."""
    _, _, model = _pair()
    sp, pos = _t(clusters["species"][0]), _t(clusters["pos"][0])
    res, _ = _count(lambda: model.energy(sp, pos))
    off = MaceGaunt(dataclasses.replace(model.cfg, fourier_resident=False), device=CPU)
    off.load_state_dict(model.state_dict())
    raw, _ = _count(lambda: off.energy(sp, pos))
    assert res == 1 + 2 * model.cfg.n_layers
    assert raw == 3 * model.cfg.n_layers


@pytest.mark.parametrize("grid_gate,chain_tune", [("off", "heuristic"), ("on", "measure")])
def test_mace_general_loss_and_double_backward_match_reference(clusters, grid_gate,
                                                               chain_tune):
    """The training loss through the general conv (its direct 2D
    convolution differentiated twice) against the reference, at one layer:
    the loss at the identity tier, every parameter's gradient at the loose
    tier."""
    ref, params, model = _pair(grid_gate=grid_gate, chain_tune=chain_tune, n_layers=1)
    batch = {k: v[:2] for k, v in clusters.items()}
    loss_ref, g = jax.jit(jax.value_and_grad(ref.loss))(params,
                                                        jax.tree.map(jnp.asarray, batch))
    ref_g = params_from_jax(jax.tree.map(np.asarray, g))
    loss = model.loss({k: _t(v) for k, v in batch.items()})
    assert_close(loss, np.float32(loss_ref), dtype="float32")
    names = [k for k, _ in model.named_parameters()]
    gs = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    top = max(float(np.abs(w.numpy()).max()) for w in ref_g.values())
    for k, gg in zip(names, gs):
        w = ref_g[k].numpy()
        err = float(np.abs(gg.numpy() - w).max())
        assert err <= 2e-3 * max(float(np.abs(w).max()), 1e-6 * top), (k, err)


# --------------------------------------------------------------------------
# so3 and the constant cache
# --------------------------------------------------------------------------


def test_euler_roundtrip():
    rng = np.random.default_rng(7)
    for _ in range(20):
        a, b, g = (rng.uniform(-math.pi, math.pi), rng.uniform(0.05, math.pi - 0.05),
                   rng.uniform(-math.pi, math.pi))
        R = so3.rotation_matrix_zyz(a, b, g)
        np.testing.assert_allclose(so3.rotation_matrix_zyz(*so3.euler_from_matrix_zyz(R)), R,
                                   atol=1e-10)
    # the gimbal poles fold into alpha
    for b in (0.0, math.pi):
        R = so3.rotation_matrix_zyz(0.4, b, 0.3)
        np.testing.assert_allclose(so3.rotation_matrix_zyz(*so3.euler_from_matrix_zyz(R)), R,
                                   atol=1e-10)


def test_align_to_z():
    from repro.core import so3 as ref_so3

    rng = np.random.default_rng(8)
    for _ in range(20):
        r = rng.normal(size=3)
        r /= np.linalg.norm(r)
        angles = so3.align_to_z_angles(r)
        assert angles == ref_so3.align_to_z_angles(r)
        R = so3.rotation_matrix_zyz(*angles)
        np.testing.assert_allclose(R @ r, [0, 0, 1], atol=1e-10)
        # SH filter sparsity at the zenith: only m == 0 survives
        S = so3.real_sph_harm(4, R @ r)
        for l in range(5):
            for m in range(-l, l + 1):
                if m != 0:
                    assert abs(S[l * l + l + m]) < 1e-9


def test_plan_cache_hit_and_constants_built_once():
    """Planning the same op twice returns the same plan and builds no
    constants; applying it twice builds none either (the plan warms them)."""
    eng = engine.GauntEngine()
    # unusual degrees, so other tests have not warmed these entries
    p1 = eng.plan(5, 1, 4, backend="fft", device=CPU)
    first = {k: v[1] for k, v in constants.cache_stats().items()}
    p2 = eng.plan(5, 1, 4, backend="fft", device=CPU)
    assert p1 is p2
    x1, x2 = _t(random_irreps(5, (2,), 40)), _t(random_irreps(1, (2,), 41))
    p2.apply(x1, x2)
    p2.apply(x1, x2)
    assert {k: v[1] for k, v in constants.cache_stats().items()} == first
    assert set(first) >= {"y_dense", "z_dense", "gaunt_dense", "chain_matrices_folded"}


def test_clear_all_drops_every_builder_and_device_copy():
    constants.gaunt_dense(1, 1, 2)
    constants.to_torch(constants.gaunt_dense(1, 1, 2), CPU)
    assert constants.cache_stats()["gaunt_dense"][2] > 0
    constants.clear_all()
    assert all(v[2] == 0 for v in constants.cache_stats().values())
    assert constants._TORCH == {}
    p = engine.GauntEngine().plan(1, 1, 2, backend="direct", device=CPU)
    x = _t(random_irreps(1, (3,), 5))
    np.testing.assert_allclose(p.apply(x, x).numpy(),
                               gaunt_einsum_reference(x, x, 1, 1).numpy(), atol=1e-5)


def test_resident_rep_is_a_rep():
    conv = EquivariantConv(1, 1, 2, method="general", backend="rfft", device=CPU)
    f = conv.filter_rep(_t(random_unit_vectors((2,), 3)))
    assert isinstance(f, Rep) and f.is_fourier and f.form == "half"
