"""The port's SegnnNBody and SelfmixLayer against the reference, with the
parameters converted from the reference's ``init``: SEGNN's forward, loss
and gradients on every tensor-product route (tp_impl gaunt / gaunt_fused /
gaunt_auto / cg, resident on and off, grid_gate off and on, chain_tune
heuristic and measure, and each chain backend pinned, the kernel's
autograd Function included); Selfmix on every route and at bf16; and the
twins of the reference's E(3) and training checks
(tests/test_equivariant_models.py).

Tiers: 3e-4 for f32 outputs (`repro.testing.tol_for('float32')`), 2e-3
scale-relative for gradients, 5e-2 for bf16; the reference tests' own
bounds for the symmetry checks (2e-3 SEGNN, 3e-3 Selfmix)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gaunt_ff import EquivariantConfig as RefCfg
from repro.models.equivariant import SegnnNBody as RefSegnn
from repro.models.equivariant import SelfmixLayer as RefSelfmix
from repro.testing import assert_close
from repro_torch.configs.gaunt_ff import (EquivariantConfig, gaunt_equiformer_selfmix,
                                          gaunt_segnn_nbody)
from repro_torch.core import engine
from repro_torch.core.irreps import num_coeffs
from repro_torch.core.so3 import rotation_matrix_zyz, wigner_D_real_packed
from repro_torch.data import nbody_dataset
from repro_torch.models.convert import segnn_params_from_jax, selfmix_params_from_jax
from repro_torch.models.equivariant import SegnnNBody, SelfmixLayer

# the reference's test config (tests/test_equivariant_models.py)
SEGNN = dict(name="t", kind="segnn", L=1, L_edge=1, channels=8, n_layers=2, hidden=16,
             n_radial=4)
GRAD_TOL = 2e-3


def _segnn(seed=0, **kw):
    ref = RefSegnn(RefCfg(**SEGNN, **kw))
    params = ref.init(jax.random.PRNGKey(seed))
    model = SegnnNBody(EquivariantConfig(**SEGNN, **kw), device="cpu")
    model.load_state_dict(segnn_params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, params, model


@pytest.fixture(scope="module")
def data():
    return nbody_dataset(3, horizon=100, seed=1)


def _tb(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _grads_close(model, got_loss, ref_grads):
    want = {k: v.numpy() for k, v in segnn_params_from_jax(
        jax.tree.map(np.asarray, ref_grads)).items()}
    got = dict(zip([n for n, _ in model.named_parameters()],
                   torch.autograd.grad(got_loss, list(model.parameters()))))
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-6 * top), (k, err)


def _check_segnn(ref, params, model, data):
    b = {k: jnp.asarray(v) for k, v in data.items()}
    want = jax.vmap(lambda c, p, v: ref.forward(params, c, p, v))(b["charge"], b["pos"], b["vel"])
    t = _tb(data)
    got = model(t["charge"], t["pos"], t["vel"])
    assert_close(got.detach().numpy(), np.asarray(want), dtype="float32")
    ref_loss, ref_grads = jax.value_and_grad(ref.loss)(params, b)
    loss = model.loss(t)
    assert_close(loss.item(), float(ref_loss), dtype="float32")
    _grads_close(model, loss, ref_grads)


@pytest.mark.parametrize("tp_impl,resident,grid_gate,chain_tune", [
    ("gaunt", True, "off", "heuristic"),
    ("gaunt", True, "off", "measure"),
    ("gaunt", False, "off", "heuristic"),
    ("gaunt", True, "on", "heuristic"),
    ("gaunt", True, "on", "measure"),
    ("gaunt_fused", True, "off", "heuristic"),
    ("gaunt_auto", True, "off", "heuristic"),
    ("cg", True, "off", "heuristic"),
    ("cg", False, "on", "heuristic"),
])
def test_segnn_forward_loss_grads_match_reference(tp_impl, resident, grid_gate, chain_tune,
                                                  data):
    ref, params, model = _segnn(0, tp_impl=tp_impl, fourier_resident=resident,
                                grid_gate=grid_gate, chain_tune=chain_tune)
    _check_segnn(ref, params, model, data)


@pytest.mark.parametrize("backend", ["tree", "looped", "fused_torch", "fused_hopper"])
def test_segnn_pinned_chain_backends_match_reference(backend, data):
    """Each chain backend on the resident route, pinned on the measured key:
    the resident filter enters the collocation routes as a grid (the
    kernel's autograd Function on the CPU runs its plain forward with the
    hand-written backward, the grid operand needing no gradient)."""
    ref, params, model = _segnn(1, chain_tune="measure")
    eng = engine.get_engine()
    rows = 3 * 5 * 5 * SEGNN["channels"]
    key = eng.chain_measure_key((1, 1), 1, "float32", rows, None, False, "cpu",
                                ("sh", "fourier"), "sh")
    with eng.pinned_chain(key, backend):
        assert eng.plan_chain((1, 1), 1, tune="measure", batch_hint=rows,
                              entry_hint=("sh", "fourier"), device="cpu").backend == backend
        _check_segnn(ref, params, model, data)
    assert ("entries", ("sh", "fourier")) in key


def test_segnn_bf16_matches_reference(data):
    ref, params, model = _segnn(2, compute_dtype="bfloat16")
    b = {k: jnp.asarray(v) for k, v in data.items()}
    want = jax.vmap(lambda c, p, v: ref.forward(params, c, p, v))(b["charge"], b["pos"], b["vel"])
    t = _tb(data)
    got = model(t["charge"], t["pos"], t["vel"])
    assert_close(got.detach().float().numpy(), np.asarray(want, np.float32), dtype="bfloat16")


def test_segnn_batched_systems_equal_one_at_a_time(data):
    """A leading batch of systems evaluates each system on its own."""
    _, _, model = _segnn(3)
    t = _tb(data)
    out = model(t["charge"], t["pos"], t["vel"])
    for s in range(3):
        one = model(t["charge"][s], t["pos"][s], t["vel"][s])
        assert_close(out[s].detach().numpy(), one.detach().numpy(), dtype="float32")


def test_segnn_equivariance():
    model = SegnnNBody(EquivariantConfig(**SEGNN), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    charge = torch.as_tensor(rng.choice([-1.0, 1.0], 5).astype(np.float32))
    pos = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    vel = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    out1 = model(charge, pos, vel)
    assert bool(torch.isfinite(out1).all())
    R = torch.as_tensor(rotation_matrix_zyz(0.5, 1.1, -0.8), dtype=torch.float32)
    out2 = model(charge, pos @ R.T, vel @ R.T)
    np.testing.assert_allclose(out2.detach().numpy(), (out1 @ R.T).detach().numpy(),
                               atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("impl", ["gaunt", "cg"])
def test_segnn_trains_nbody(impl):
    """Six plain SGD steps at lr 1e-2 on 6 systems lower the loss, as the
    reference's test holds it."""
    _, _, model = _segnn(4, tp_impl=impl)
    batch = _tb(nbody_dataset(6, horizon=200, seed=1))
    with torch.no_grad():
        l0 = model.loss(batch).item()
    for _ in range(6):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        with torch.no_grad():
            for p, g in zip(model.parameters(), grads):
                p -= 1e-2 * g
    with torch.no_grad():
        l1 = model.loss(batch).item()
    assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0, (impl, l0, l1)


# --------------------------------------------------------------------------
# Selfmix
# --------------------------------------------------------------------------


def _selfmix(impl, seed, L=2, C=4, **kw):
    ref = RefSelfmix(L=L, channels=C, tp_impl=impl, **kw)
    params = ref.init(jax.random.PRNGKey(seed))
    # non-unit per-degree weights, so the shared-operand paths are exercised
    params = jax.tree.map(lambda a: a * (1 + 0.1 * jnp.arange(a.size).reshape(a.shape)), params)
    layer = SelfmixLayer(L, C, tp_impl=impl, device="cpu", **kw)
    layer.load_state_dict(selfmix_params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, params, layer


@pytest.mark.parametrize("impl,kw", [
    ("gaunt", {}), ("gaunt", {"resident": False}), ("gaunt", {"tune": "measure"}),
    ("gaunt_fused", {}), ("gaunt_auto", {}), ("cg", {}),
])
def test_selfmix_matches_reference(impl, kw):
    ref, params, layer = _selfmix(impl, 5, **kw)
    x = np.random.default_rng(5).normal(size=(3, 4, num_coeffs(2))).astype(np.float32)
    want = ref(params, jnp.asarray(x))
    got = layer(torch.as_tensor(x))
    assert_close(got.detach().numpy(), np.asarray(want), dtype="float32")


@pytest.mark.parametrize("backend", ["tree", "looped", "fused_torch", "fused_hopper"])
def test_selfmix_pinned_chain_backends_match_reference(backend):
    """The shared-operand chain with per-operand weights (share (0, 0)) on
    each chain backend, and its input gradient against the reference's."""
    ref, params, layer = _selfmix("gaunt", 6, tune="measure")
    x = np.random.default_rng(6).normal(size=(3, 4, num_coeffs(2))).astype(np.float32)
    eng = engine.get_engine()
    key = eng.chain_measure_key((2, 2), 2, "float32", 12, (0, 0), False, "cpu")
    want, g_ref = jax.value_and_grad(lambda a: jnp.sum(ref(params, a) ** 2))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    with eng.pinned_chain(key, backend):
        assert layer.chain_plan(xt).backend == backend
        loss = (layer(xt) ** 2).sum()
    (g,) = torch.autograd.grad(loss, xt)
    assert_close(loss.item(), float(want), dtype="float32")
    assert_close(g.numpy(), np.asarray(g_ref), tol=GRAD_TOL)


@pytest.mark.parametrize("impl", ["gaunt", "gaunt_fused"])
def test_selfmix_bf16_matches_reference(impl):
    ref, params, layer = _selfmix(impl, 7, compute_dtype="bfloat16")
    x = np.random.default_rng(7).normal(size=(3, 4, num_coeffs(2))).astype(np.float32)
    want = np.asarray(ref(params, jnp.asarray(x)), np.float32)
    got = layer(torch.as_tensor(x)).detach().float().numpy()
    assert_close(got, want, dtype="bfloat16")


@pytest.mark.parametrize("impl", ["gaunt", "gaunt_fused", "cg"])
def test_selfmix_layer_equivariance(impl):
    L, C = 2, 4
    layer = SelfmixLayer(L, C, tp_impl=impl, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(3, C, num_coeffs(L)))
                        .astype(np.float32))
    D = torch.as_tensor(wigner_D_real_packed(L, 0.5, 1.1, -0.8), dtype=torch.float32)
    y1 = layer(x)
    y2 = layer(torch.einsum("ij,ncj->nci", D, x))
    np.testing.assert_allclose(torch.einsum("ij,ncj->nci", D, y1).detach().numpy(),
                               y2.detach().numpy(), atol=3e-3, rtol=1e-3)


def test_selfmix_gaunt_equals_fused():
    L, C = 2, 4
    a = SelfmixLayer(L, C, tp_impl="gaunt", device="cpu")
    b = SelfmixLayer(L, C, tp_impl="gaunt_fused", device="cpu")
    b.load_state_dict(a.state_dict())
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(3, C, num_coeffs(L)))
                        .astype(np.float32))
    np.testing.assert_allclose(a(x).detach().numpy(), b(x).detach().numpy(),
                               atol=2e-4, rtol=2e-4)


def test_selfmix_rejects_shard_spec():
    """A shard spec of an unknown mode is rejected; one with no mesh (none
    given, none registered) runs unsharded."""
    from repro_torch.core.engine import ShardSpec

    x = torch.as_tensor(np.random.default_rng(7).normal(size=(3, 4, num_coeffs(2)))
                        .astype(np.float32))
    with pytest.raises(ValueError, match="shard mode"):
        SelfmixLayer(2, 4, shard_spec=ShardSpec(mode="nope"), device="cpu")(x)
    for impl in ("gaunt", "gaunt_fused"):
        a = SelfmixLayer(2, 4, tp_impl=impl, device="cpu")
        b = SelfmixLayer(2, 4, tp_impl=impl, shard_spec=ShardSpec(), device="cpu")
        b.load_state_dict(a.state_dict())
        assert_close(b(x).detach().numpy(), a(x).detach().numpy(), dtype="float32")


def test_configs_and_no_duplicate_random_init_leaves():
    """The configs are the reference's, and every random parameter of a
    freshly initialised model is its own draw."""
    from repro.configs import gaunt_ff as ref_ff

    assert dataclasses.asdict(gaunt_segnn_nbody) == {
        k: v for k, v in dataclasses.asdict(ref_ff.gaunt_segnn_nbody).items()
        if k in dataclasses.asdict(gaunt_segnn_nbody)}
    assert (gaunt_equiformer_selfmix.L, gaunt_equiformer_selfmix.channels) == (4, 32)
    for m in (SegnnNBody(dataclasses.replace(gaunt_segnn_nbody, channels=4, n_layers=2),
                         device="cpu"), SelfmixLayer(2, 4, device="cpu")):
        rand = [p.detach().numpy().tobytes() for p in m.parameters()
                if np.unique(p.detach().numpy()).size > 1]
        assert rand and len(rand) == len(set(rand)), type(m).__name__
