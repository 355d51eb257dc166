"""The port's force-field training path against the reference:
`MaceGaunt.loss` and its double backward, the optimizers and schedules,
the training step and loop (the reference's `test_training_substrate.py`
optimizer and train-loop tests, on the force field: the port has no LM
loss yet), and the twin of `test_system.py::
test_force_field_end_to_end_with_restart`.

Parameters come from the reference's ``init`` through `params_from_jax`,
on the reference's small config.  The optimizers are held element-wise
(1e-6) on *identical* gradients.  A whole training run is held by its loss
history and its E(3) soundness, not element-wise: Adam's first update is
about -lr sign(g), so a gradient element that is zero up to rounding can
take either sign in JAX and in torch, and the runs part by 2 lr there."""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.config import TrainConfig as RefTrainConfig
from repro.configs.gaunt_ff import gaunt_mace_ff as ref_cfg
from repro.models.equivariant import MaceGaunt as RefMace
from repro.testing import assert_close
from repro.train import make_train_step as ref_make_train_step
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.core.so3 import rotation_matrix_zyz
from repro_torch.data import lj_dataset
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.train import make_train_step, train_loop

# the reference's small config (tests/test_system.py)
SMALL = dict(channels=8, L=1, L_edge=1, n_layers=1, nu=2, n_radial=4, hidden=16)
GRAD_TOL = 2e-3  # the f32 loose tier, scale-relative


def _pair(seed=0, **over):
    kw = dict(SMALL, **over)
    ref = RefMace(dataclasses.replace(ref_cfg, **kw))
    params = ref.init(jax.random.PRNGKey(seed))
    model = MaceGaunt(dataclasses.replace(gaunt_mace_ff, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, params, model


def _torch_batch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _grads_close(got: dict, want: dict, tol=GRAD_TOL):
    """Per leaf, scale-relative; a leaf whose reference gradient is exactly
    zero (the gate's, in a one-layer model) is held at f32 rounding of the
    largest gradient."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = got[k].detach().numpy()
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-6 * top), (k, err)


def _ref_grads(ref, params, batch):
    loss, g = jax.value_and_grad(ref.loss)(params, jax.tree.map(jnp.asarray, batch))
    return float(loss), {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, g)).items()}


# ---------------------------------------------------------------- loss


@pytest.fixture(scope="module")
def data():
    """12 LJ clusters of 6 atoms; every reference call below takes batches
    of 6 of them, so JAX compiles each op for one shape only."""
    return lj_dataset(12, n_atoms=6, n_species=4, seed=0)


def _first(data, n=6):
    return {k: v[:n].copy() for k, v in data.items()}


@pytest.mark.parametrize("grid_gate,chain_tune", [("off", "heuristic"), ("on", "measure")])
def test_loss_and_double_backward_match_reference(data, grid_gate, chain_tune):
    """The loss at the f32 identity tier, and every parameter's gradient of
    it (through the forces: a double backward) at the loose tier."""
    ref, params, model = _pair(grid_gate=grid_gate, chain_tune=chain_tune)
    d = _first(data)
    ref_loss, ref_g = _ref_grads(ref, params, d)
    loss = model.loss(_torch_batch(d))
    assert_close(loss.detach().numpy(), np.float32(ref_loss), dtype="float32")
    gs = torch.autograd.grad(loss, list(model.parameters()))
    _grads_close(dict(zip(dict(model.named_parameters()), gs)), ref_g)


def test_double_backward_finite_at_masked_edges(data):
    """A molecule with an atom beyond the cutoff and the self-pairs: the
    masked-edge placeholders (unit direction, clamped radius) stay finite
    under the double backward, as in the reference, and agree with it."""
    ref, params, model = _pair()
    d = _first(data)
    d["pos"][1, 5] = d["pos"][1, 0] + np.float32(ref_cfg.cutoff + 1.5)
    ref_loss, ref_g = _ref_grads(ref, params, d)
    loss = model.loss(_torch_batch(d))
    gs = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in gs)
    assert np.isfinite(ref_loss)
    _grads_close(dict(zip(dict(model.named_parameters()), gs)), ref_g)


def test_energy_forces_unchanged_by_loss(data):
    """The served `energy_forces` stays detached; the loss keeps its graph."""
    _, _, model = _pair()
    d = _torch_batch(_first(data, 2))
    e, f = model.energy_forces(d["species"], d["pos"])
    assert not e.requires_grad and not f.requires_grad
    assert model.loss(d).requires_grad


# ---------------------------------------------------------------- optimizers


def test_adamw_matches_reference_numpy():
    """One AdamW step vs a hand-written numpy reference (the reference's
    test, on the port)."""
    lr = 1e-2
    opt = optim.adamw(lambda s: lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
    params = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]]), "b": torch.tensor([0.1, -0.1])}
    grads = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]]), "b": torch.tensor([0.01, -0.02])}
    before = {k: v.clone() for k, v in params.items()}
    upd, _ = opt.update(grads, opt.init(params), params)
    optim.apply_updates(params, upd)
    for k, decay in (("w", 0.1), ("b", 0.0)):
        g = grads[k].numpy()
        mh = 0.1 * g / (1 - 0.9)
        vh = 0.001 * g * g / (1 - 0.999)
        p0 = before[k].numpy()
        ref = p0 - lr * (mh / (np.sqrt(vh) + 1e-8) + decay * p0)
        np.testing.assert_allclose(params[k].numpy(), ref, atol=1e-6)


def test_clip_by_global_norm():
    clipped, n = optim.clip_by_global_norm({"a": torch.full((3,), 10.0)}, 1.0)
    np.testing.assert_allclose(float(n), np.sqrt(300.0), rtol=1e-5)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0, rtol=1e-5)
    small, _ = optim.clip_by_global_norm({"a": torch.full((3,), 1e-3)}, 1.0)
    assert torch.equal(small["a"], torch.full((3,), 1e-3))  # below the norm: as is


def test_cosine_schedule_shape():
    lr = optim.cosine_schedule(1.0, warmup=10, total=110)
    assert lr(0) == 0.0
    np.testing.assert_allclose(lr(10), 1.0, atol=1e-6)
    assert lr(110) < 0.2


@pytest.mark.parametrize("name", ["cosine", "linear", "constant"])
def test_schedules_match_reference(name):
    mk = {"cosine": lambda m: m.cosine_schedule(2e-3, 4, 20),
          "linear": lambda m: m.linear_schedule(2e-3, 4, 20),
          "constant": lambda m: m.constant_schedule(2e-3)}[name]
    got, want = mk(optim), mk(ref_optim)
    for s in range(0, 25):
        np.testing.assert_allclose(got(s), float(want(jnp.asarray(s))), rtol=1e-6, atol=0)


_OPTS = {
    "adamw": lambda m, fn: m.adamw(fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1),
    "lion": lambda m, fn: m.lion(fn, b1=0.9, b2=0.99, weight_decay=0.1),
    "sgd": lambda m, fn: m.sgd(fn, momentum=0.9),
}


@pytest.mark.parametrize("name", list(_OPTS))
def test_optimizer_matches_reference_on_identical_grads(name):
    """Five steps of clip + optimizer on the same numpy gradients, cosine
    warmup on: parameters and state equal the reference's to 1e-6."""
    _, params, model = _pair()
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(np.asarray, params)
    steps = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.3,
                          np_params) for _ in range(5)]
    ref_opt = _OPTS[name](ref_optim, ref_optim.cosine_schedule(1e-2, 3, 10))
    opt = _OPTS[name](optim, optim.cosine_schedule(1e-2, 3, 10))
    rp, rs = params, ref_opt.init(params)
    tp = dict(model.named_parameters())
    ts = opt.init(tp)
    norms = []
    for g in steps:
        rg, rn = ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        u, rs = ref_opt.update(rg, rs, rp)
        rp = ref_optim.apply_updates(rp, u)
        tg, tn = optim.clip_by_global_norm(
            {k: v for k, v in params_from_jax(g).items()}, 1.0)
        u, ts = opt.update(tg, ts, tp)
        optim.apply_updates(tp, u)
        norms.append((float(rn), float(tn)))
    assert all(r > 1.0 for r, _ in norms)  # the clip is active
    np.testing.assert_allclose([t for _, t in norms], [r for r, _ in norms], rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, rp))
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    want_s = opt_state_from_jax(jax.tree.map(np.asarray, rs))
    assert int(ts["step"]) == int(want_s["step"]) == 5
    for m in ("mu", "nu"):
        for k in want_s.get(m, {}):
            np.testing.assert_allclose(ts[m][k].numpy(), want_s[m][k].numpy(), atol=1e-6)


# ---------------------------------------------------------------- train loop


class Batches:
    """The reference test's resumable iterator over a fixed LJ set."""

    def __init__(self, data, n=12, batch=6, seed=7):
        self.data, self.n, self.batch, self.seed, self.step = data, n, batch, seed, 0

    def state(self):
        return {"step": self.step}

    def restore(self, s):
        self.step = int(s["step"])

    def next_batch(self):
        rng = np.random.default_rng((self.seed, self.step))
        idx = rng.choice(self.n, self.batch, replace=False)
        self.step += 1
        return {k: v[idx] for k, v in self.data.items()}


def _loss_fn(m, batch):
    return m.loss(batch), {}


@pytest.mark.parametrize("cross_at", [0, 2])
def test_train_step_matches_reference_loss_history(data, cross_at):
    """The port's trainer picks up the reference's state (parameters by
    `params_from_jax`, optimizer state by `opt_state_from_jax`) after
    ``cross_at`` reference steps, and both go on for four steps: the losses
    agree at the f32 identity tier at the first shared step and at the
    loose tier after (Adam sign flips, see the module docstring); the
    gradient norms likewise."""
    ref, params, _ = _pair()
    tcfg = TrainConfig(lr=2e-3, warmup_steps=2, total_steps=8, grad_clip=10.0)
    rstep, ropt = ref_make_train_step(lambda p, b: (ref.loss(p, b), {}),
                                      RefTrainConfig(**dataclasses.asdict(tcfg)))
    step, _ = make_train_step(_loss_fn, tcfg)
    rs = ropt.init(params)
    it = Batches(data)
    for _ in range(cross_at):
        params, rs, _ = rstep(params, rs, jax.tree.map(jnp.asarray, it.next_batch()))
    _, _, model = _pair()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ts = opt_state_from_jax(jax.tree.map(np.asarray, rs))
    assert int(ts["step"]) == cross_at
    hist = []
    for _ in range(4):
        b = it.next_batch()
        params, rs, rm = rstep(params, rs, jax.tree.map(jnp.asarray, b))
        ts, tm = step(model, ts, _torch_batch(b))
        hist.append((float(rm["loss"]), float(tm["loss"]),
                     float(rm["grad_norm"]), float(tm["grad_norm"])))
    assert_close(np.float32(hist[0][1]), np.float32(hist[0][0]), dtype="float32")
    for rl, tl, rn, tn in hist:
        assert abs(tl - rl) <= GRAD_TOL * abs(rl), hist
        assert abs(tn - rn) <= GRAD_TOL * abs(rn), hist
    assert int(ts["step"]) == int(rs["step"]) == cross_at + 4


def test_train_loop_loss_decreases(tmp_path, data):
    """On one fixed set of 6 clusters (each batch is all of them), the loss
    falls at every step; checkpoints land every 6 steps."""
    _, _, model = _pair()
    tcfg = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=12, checkpoint_every=6,
                       log_every=1, grad_clip=10.0)
    state, hist = train_loop(_loss_fn, model, Batches(_first(data), n=6), tcfg,
                             ckpt_dir=str(tmp_path))
    losses = [h["loss"] for h in hist]
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert np.all(np.diff(losses) < 0), losses
    assert state.step == 12
    assert CheckpointManager(str(tmp_path)).all_steps() == [6, 12]


def _stop_at(k):
    """A log hook that preempts the run (SIGTERM) at step k: the loop saves
    a blocking checkpoint there and stops, with its schedule unchanged."""
    def log(m):
        if m["step"] == k:
            os.kill(os.getpid(), signal.SIGTERM)
    return log


def test_train_loop_resume_equals_uninterrupted(tmp_path, data):
    """Stop at step 3, resume to 6: parameters equal the uninterrupted
    run's, and the data iterator resumed rather than replayed."""
    tcfg = TrainConfig(lr=2e-3, warmup_steps=2, total_steps=6, checkpoint_every=100,
                       log_every=1, grad_clip=10.0)
    _, _, straight = _pair()
    train_loop(_loss_fn, straight, Batches(data), tcfg)
    _, _, model = _pair()
    state, _ = train_loop(_loss_fn, model, Batches(data), tcfg, ckpt_dir=str(tmp_path),
                          hooks={"log": _stop_at(3)})
    assert state.step == 3 and CheckpointManager(str(tmp_path)).all_steps() == [3]
    _, _, fresh = _pair()  # a new process: the initial parameters again
    it = Batches(data)
    state, hist = train_loop(_loss_fn, fresh, it, tcfg, ckpt_dir=str(tmp_path))
    assert state.step == 6 and it.step == 6 and [h["step"] for h in hist] == [4, 5, 6]
    assert int(state.opt_state["step"]) == 6
    for a, b in zip(fresh.parameters(), straight.parameters()):
        assert_close(a.detach().numpy(), b.detach().numpy(), dtype="float32")


def test_grad_accumulation_equivalence(data):
    """Two microbatches of 3 give the update of one batch of 6 (the loss is
    a mean over molecules)."""
    b = _torch_batch(Batches(data).next_batch())
    out = []
    for mb in (0, 2):
        _, _, model = _pair()
        step, opt = make_train_step(_loss_fn, TrainConfig(lr=1e-3, warmup_steps=1,
                                                          total_steps=10, microbatch=mb))
        _, m = step(model, opt.init(dict(model.named_parameters())), b)
        out.append((float(m["loss"]), [p.detach().clone() for p in model.parameters()]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    d = max(float((p - q).abs().max()) for p, q in zip(out[0][1], out[1][1]))
    assert d < 5e-3, d


def test_preemption_checkpoints_and_stops(tmp_path, data):
    """SIGTERM mid-run: a blocking checkpoint at that step, the loop stops,
    and the handler that was installed before is back afterwards."""
    _, _, model = _pair()
    tcfg = TrainConfig(lr=2e-3, warmup_steps=2, total_steps=10, checkpoint_every=100,
                       log_every=1, grad_clip=10.0)
    before = signal.getsignal(signal.SIGTERM)
    state, hist = train_loop(_loss_fn, model, Batches(data), tcfg, ckpt_dir=str(tmp_path),
                             hooks={"log": _stop_at(3),
                                    "heartbeat_path": str(tmp_path / "hb.json")})
    assert state.step == 3 and hist[-1]["step"] == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is before
    assert (tmp_path / "hb.json").exists()


def test_force_field_end_to_end_with_restart(tmp_path, data):
    """Train the paper-side model, stop it mid-run, resume from the
    checkpoint, and verify the final model is E(3)-sound (the reference's
    test_system.py test, on the port)."""
    _, _, model = _pair()
    t1 = TrainConfig(lr=2e-3, warmup_steps=2, total_steps=8, checkpoint_every=4,
                     log_every=4, grad_clip=10.0)
    train_loop(_loss_fn, model, Batches(data), t1, ckpt_dir=str(tmp_path))
    t2 = dataclasses.replace(t1, total_steps=14)
    b2 = Batches(data)
    _, _, model2 = _pair()
    state, hist = train_loop(_loss_fn, model2, b2, t2, ckpt_dir=str(tmp_path))
    assert state.step == 14
    assert b2.step == 14  # data pipeline resumed, not replayed
    R = torch.as_tensor(rotation_matrix_zyz(0.4, 1.0, -0.2), dtype=torch.float32)
    s0, p0 = torch.as_tensor(data["species"][0]), torch.as_tensor(data["pos"][0])
    e1, f1 = state.model.energy_forces(s0, p0)
    e2, f2 = state.model.energy_forces(s0, p0 @ R.T)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-4, atol=1e-3)
    assert_close(f2.numpy(), (f1 @ R.T).numpy(), dtype="float32", tier="transform")
