"""Two-rank parity of the port's distribution on the CPU, with gloo: every
sharded path against the reference's UNSHARDED output on the same numpy
inputs (the reference's own sharded tests fail on jax 0.9.0, ROADMAP
"Reference notes").

The two ranks are spawned once for the module (`tests/_torch_dist_worker.py`,
a FileStore in a temporary directory: no network) and run every case; the
reference side runs here with ``JAX_PLATFORMS=cpu``.  Each test checks that
both ranks hold the same result (the gathered rows are replicated) and
that it equals the reference's.  Cases: `plan_chain` and `plan_batch` with
ragged rows (values and gradients, the pinned kernel backends' plain
versions), `EquivariantConv`, `manybody_gaunt_product` and `SelfmixLayer`
with a `ShardSpec`, reduced `MaceGaunt` with ``shard_data`` (energy,
forces, the loss and its double backward), three `train_loop` steps of
reduced qwen2-0.5b on a (2, 1) and a (1, 2) mesh, a checkpoint written on
(2, 1) and resumed on (1, 2), `int8_ef_cross_pod_mean` at pod=2 (against
the numpy formula) and pod=1 (against the reference), the launcher under
torchrun, and twins of the reference's elastic tests.

Tolerances: the f32 tiers of `repro_torch.testing.tol_for`, 3e-4 for values
and 2e-3 ("loose") for gradients."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget_config
from repro.configs.gaunt_ff import gaunt_mace_ff as ref_mace_cfg
from repro.core import engine as ref_engine
from repro.core.conv import EquivariantConv as RefConv
from repro.core.manybody import manybody_gaunt_product as ref_manybody
from repro.data import LMTokenPipeline as JPipeline
from repro.distributed.collectives import int8_ef_cross_pod_mean as ref_int8
from repro.models import build_model as jbuild_model
from repro.models.equivariant import MaceGaunt as RefMace
from repro.models.equivariant import SelfmixLayer as RefSelfmix
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply_updates
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.train import train_loop as jtrain_loop
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.data import lj_dataset
from repro_torch.models.convert import (lm_params_from_jax, params_from_jax,
                                        selfmix_params_from_jax)
from repro_torch.testing import assert_close

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 2
MACE = dict(channels=4, n_layers=2, L=2, L_edge=3, n_species=4)
LM_OVER = dict(n_layers=1, d_model=64, d_ff=128, vocab=64, n_heads=2, n_kv_heads=2,
               head_dim=32)
LM_TCFG = dict(lr=5e-3, warmup_steps=2, log_every=1)
MACE_TCFG = dict(lr=2e-3, warmup_steps=1, total_steps=2, grad_clip=10.0, log_every=1)


def _r(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _unit(shape, seed):
    v = _r(shape + (3,), seed)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _inputs() -> dict:
    """The numpy inputs both sides take (as float32)."""
    a = {
        "chain_x": _r((7, 3, 9), 1), "chain_w": _r((7, 3, 3), 2), "chain_cot": _r((7, 3, 9), 3),
        "b_a1": _r((5, 9), 4), "b_a2": _r((5, 9), 5), "b_b1": _r((3, 4), 6),
        "b_b2": _r((3, 9), 7), "b_c1": _r((5, 25), 8), "b_c2": _r((3, 16), 9),
        "c_x": _r((5, 2, 9), 10), "c_r": _unit((5, 1), 11), "c_w1": _r((5, 2, 3), 12),
        "c_cot": _r((5, 2, 9), 13),
        "m_x1": _r((5, 4), 14), "m_x2": _r((5, 9), 15), "m_x3": _r((5, 4), 16),
        "s_x": _r((3, 4, 9), 17), "s_cot": _r((3, 4, 9), 18),
        "q_g": _r((2, 33), 19, 3.0), "q_h": _r((2, 4, 5), 20), "q_e": _r((2, 33), 21, 0.01),
    }
    return a


def _selfmix_ref(impl):
    ref = RefSelfmix(L=2, channels=4, tp_impl=impl)
    params = ref.init(jax.random.PRNGKey(5))
    params = jax.tree.map(lambda a: a * (1 + 0.1 * jnp.arange(a.size).reshape(a.shape)), params)
    return ref, params


def _mace_ref():
    ref = RefMace(dataclasses.replace(ref_mace_cfg, **MACE))
    return ref, ref.init(jax.random.PRNGKey(0))


def _lm_ref():
    jcfg = jget_config("qwen2-0.5b").reduced(**LM_OVER)
    jm = jbuild_model(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two gloo ranks once; -> (rank 0's results, rank 1's, the
    numpy inputs)."""
    d = str(tmp_path_factory.mktemp("dist"))
    a = _inputs()
    inp = {k: torch.as_tensor(v) for k, v in a.items()}
    for impl in ("gaunt", "gaunt_fused"):
        _, params = _selfmix_ref(impl)
        inp[f"s_state_{impl}"] = selfmix_params_from_jax(_np_tree(params))
    _, mparams = _mace_ref()
    clusters = lj_dataset(2, n_atoms=5, n_species=4, seed=3)
    inp["mace_cfg"], inp["mace_tcfg"] = MACE, MACE_TCFG
    inp["mace_state"] = params_from_jax(_np_tree(mparams))
    for k, v in clusters.items():
        inp["mace_" + k] = torch.as_tensor(v)
    _, _, jparams = _lm_ref()
    inp["lm_over"], inp["lm_tcfg"] = LM_OVER, LM_TCFG
    inp["lm_params"] = lm_params_from_jax(_np_tree(jparams))
    torch.save(inp, os.path.join(d, "inputs.pt"))
    # two threads a rank: the suite runs beside other test processes
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
                               str(r), str(WORLD), d], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=420)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return outs[0], outs[1], a, clusters


def _same(x, y):
    """Both ranks hold the same result (bit for bit: the rows are gathered)."""
    if isinstance(x, dict):
        assert set(x) == set(y)
        for k in x:
            _same(x[k], y[k])
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y)
        for p, q in zip(x, y):
            _same(p, q)
    elif isinstance(x, torch.Tensor):
        assert torch.equal(x, y)
    else:
        assert x == y


def _case(run, name, same: bool = True):
    """Rank 0's result of a case, after checking that neither rank raised
    and (``same``) that both hold the same result."""
    r0, r1 = run[0][name], run[1][name]
    for r in (r0, r1):
        assert "error" not in r, r["error"]
    if same:
        _same(r0, r1)
    return r0


def _j(a):
    return jnp.asarray(a)


def test_workers_import_no_jax_and_no_reference(run):
    assert run[0]["jax_loaded"] is False and run[1]["jax_loaded"] is False


@pytest.mark.parametrize("case", ["chain", "chain_shard_map"])
@pytest.mark.parametrize("backend", ["None", "fused_hopper"])
def test_sharded_chain_ragged_rows_matches_reference(run, case, backend):
    """21 rows (7 x 3) over 2 ranks: values at 3e-4, the gradients of x and
    of the per-degree weights at 2e-3; unpinned is 'tree', pinned runs the
    kernel backend's plain version per rank; both modes alike."""
    res = _case(run, case)
    a = run[2]
    assert res[f"{backend}_backend"] == ("tree" if backend == "None" else "fused_hopper")
    assert res[f"{backend}_one_plan_for_both_modes"] is True
    y, gx, gw = res[backend]
    cp = ref_engine.plan_chain((2, 2, 2), 2)

    def f(x, w):
        return jnp.sum(cp.apply([x, x, x], weights=[w, w, None]) * _j(a["chain_cot"]))

    want = cp.apply([_j(a["chain_x"])] * 3, weights=[_j(a["chain_w"])] * 2 + [None])
    jgx, jgw = jax.grad(f, argnums=(0, 1))(_j(a["chain_x"]), _j(a["chain_w"]))
    assert_close(y, np.asarray(want), dtype="float32")
    assert_close(gx, np.asarray(jgx), dtype="float32", tier="loose")
    assert_close(gw, np.asarray(jgw), dtype="float32", tier="loose")


def test_sharded_batch_ragged_rows_matches_reference(run):
    """Items of 5 and 3 rows pad to the 2-rank granularity and slice back:
    values and every operand's gradient against the reference's unsharded
    buckets; the pinned pair-kernel bucket's values too."""
    res = _case(run, "batch")
    a = run[2]
    assert res["granularity"] == 2
    items = [(2, 2, 4, 5), (1, 2, 3, 3)]
    bp = ref_engine.plan_batch(items)
    names = ["b_a1", "b_a2", "b_b1", "b_b2"]

    def f(*ops):
        out = bp.apply([(ops[0], ops[1]), (ops[2], ops[3])])
        return sum(jnp.sum(o * _j(a[c])) for o, c in zip(out, ("b_c1", "b_c2")))

    want = bp.apply([(_j(a["b_a1"]), _j(a["b_a2"])), (_j(a["b_b1"]), _j(a["b_b2"]))])
    grads = jax.grad(f, argnums=(0, 1, 2, 3))(*[_j(a[n]) for n in names])
    for got, w in zip(res["values"], want):
        assert_close(got, np.asarray(w), dtype="float32")
    for got, w in zip(res["kernel"], want):
        assert_close(got, np.asarray(w), dtype="float32")
    for got, w in zip(res["grads"], grads):
        assert_close(got, np.asarray(w), dtype="float32", tier="loose")


@pytest.mark.parametrize("method", ["escn", "general"])
def test_sharded_conv_matches_reference(run, method):
    """EquivariantConv(shard_spec): eSCN on WignerBlocks and on raw
    directions, the general conv on the resident filter and on raw
    directions; the direction gradient (what forces take) at 2e-3."""
    res = _case(run, "conv")
    a = run[2]
    ref = RefConv(2, 2, 2, method=method)

    def f(r):
        geom = ref.geometry_rep(r) if method == "escn" else ref.filter_rep(r)
        return ref(_j(a["c_x"]), geom, w1=_j(a["c_w1"]))

    want = f(_j(a["c_r"]))
    g = jax.grad(lambda r: jnp.sum(f(r) * _j(a["c_cot"])))(_j(a["c_r"]))
    y, gr = res[method]
    assert_close(y, np.asarray(want), dtype="float32")
    assert_close(res[method + "_raw"], np.asarray(want), dtype="float32")
    assert_close(gr, np.asarray(g), dtype="float32", tier="loose")


@pytest.mark.parametrize("route", ["chain", "packed"])
def test_sharded_manybody_matches_reference(run, route):
    res = _case(run, "manybody")
    a = run[2]
    xs = [_j(a["m_x1"]), _j(a["m_x2"]), _j(a["m_x3"])]
    kw = {"conversion": "packed"} if route == "packed" else {}
    want = ref_manybody(xs, [1, 2, 1], Lout=2, **kw)
    assert_close(res[route], np.asarray(want), dtype="float32")


@pytest.mark.parametrize("impl", ["gaunt", "gaunt_fused"])
def test_sharded_selfmix_matches_reference(run, impl):
    res = _case(run, "selfmix")
    a = run[2]
    ref, params = _selfmix_ref(impl)
    want = ref(params, _j(a["s_x"]))
    g = jax.grad(lambda x: jnp.sum(ref(params, x) * _j(a["s_cot"])))(_j(a["s_x"]))
    y, gx = res[impl]
    assert_close(y, np.asarray(want), dtype="float32")
    assert_close(gx, np.asarray(g), dtype="float32", tier="loose")


def test_sharded_mace_energy_forces_match_reference(run):
    """shard_data=True on the activation mesh: each molecule's energy at
    3e-4 and its forces at 2e-3 of their scale."""
    res = _case(run, "mace")
    ref, params = _mace_ref()
    cl = run[3]
    for s in range(len(cl["pos"])):
        e, g = jax.value_and_grad(lambda p: ref.energy(params, _j(cl["species"][s]), p))(
            _j(cl["pos"][s]))
        assert_close(res["energy"][s], np.float32(e), dtype="float32")
        f_ref = -np.asarray(g)
        assert_close(res["forces"][s], f_ref, tol=2e-3 * float(np.abs(f_ref).max()))


def test_sharded_mace_loss_double_backward_matches_reference(run):
    """The force loss (forces through the row gather, differentiated once
    more): the loss at 3e-4, every parameter's gradient at 2e-3 of its
    scale."""
    res = _case(run, "mace")
    ref, params = _mace_ref()
    batch = jax.tree.map(jnp.asarray, dict(run[3]))
    loss, g = jax.value_and_grad(ref.loss)(params, batch)
    ref_g = params_from_jax(_np_tree(g))
    assert_close(res["loss"], np.float32(loss), dtype="float32")
    top = max(float(np.abs(w.numpy()).max()) for w in ref_g.values())
    for k, gg in res["grads"].items():
        w = ref_g[k].numpy()
        err = float(np.abs(gg.numpy() - w).max())
        assert err <= 2e-3 * max(float(np.abs(w).max()), 1e-6 * top), (k, err)


def test_sharded_serving_measures_no_chain(run):
    """shard_data with chain_tune='measure', served on the activation mesh:
    warmup makes no timing run (sharded chains are 'tree' and never consult
    the measured cache, as the reference's warmup skips them), and every
    served energy and force equals the unsharded model's direct one."""
    res = _case(run, "serve")
    assert res["timing_runs"] == 0 and all(res["done"])
    for (e, f), (e0, f0) in zip(res["served"], res["direct"]):
        assert_close(e, e0, dtype="float32")
        assert_close(f, f0, tol=2e-3 * max(float(f0.abs().max()), 1e-30))


@pytest.fixture(scope="module")
def lm_reference():
    """The reference's unsharded jitted train loop, 3 steps, at the tiny
    qwen2 config from the same parameters and pipeline."""
    jcfg, jm, jparams = _lm_ref()
    state, hist = jtrain_loop(jm.loss, jparams,
                              JPipeline(vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=0),
                              JTrainConfig(total_steps=3, **LM_TCFG), hooks={})
    return ([h["loss"] for h in hist], lm_params_from_jax(_np_tree(state.params)),
            [h["grad_norm"] for h in hist])


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}.{i}" if path else str(i))
    else:
        yield path, tree


def _check_lm(res, lm_reference, steps=(1, 2, 3)):
    """The losses and gradient norms of ``steps`` and, when the run ended at
    step 3, the parameters, against the reference's."""
    want_loss, want_params, want_norm = lm_reference
    assert res["steps"] == list(steps)
    for got, w in zip(res["loss"], want_loss[steps[0] - 1:]):
        assert_close(np.float32(got), np.float32(w), dtype="float32")
    for got, w in zip(res["grad_norm"], want_norm[steps[0] - 1:]):
        assert abs(got - w) <= 2e-3 * abs(w), (res["grad_norm"], want_norm)
    if steps[-1] != len(want_loss):
        return
    for k, w in _flat(want_params):
        got = res["params"][k]
        assert_close(got, w.numpy(), tol=2e-3 * float(np.abs(w.numpy()).max()) + 1e-4)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_sharded_train_step_matches_reference(run, lm_reference, mesh):
    """Three steps with the parameters and optimizer state as DTensors on a
    (2, 1) and a (1, 2) mesh: the global-batch loss at every step at 3e-4,
    the parameters after the last at 2e-3 of each leaf's scale."""
    res = _case(run, "train")[mesh]
    assert res["mu_is_dtensor"] == "DTensor"
    _check_lm(res, lm_reference)


def test_sharded_train_of_a_mace_model_matches_reference(run):
    """A module that reads its weights as attributes (MaceGaunt, shard_data
    off) trains on (2, 1) on its weights gathered whole, one molecule a
    rank: the global-batch loss and the gradient norm (the mean over the
    ranks of each one's gradient, through the force loss's double
    backward) against the reference's unsharded step, at 3e-4 on the first
    step and 2e-3 after."""
    got = _case(run, "mace_train")[False]
    ref, params = _mace_ref()
    rstep, ropt = jmake_train_step(lambda p, b: (ref.loss(p, b), {}), JTrainConfig(**MACE_TCFG))
    rs, batch, want = ropt.init(params), jax.tree.map(jnp.asarray, dict(run[3])), []
    for _ in range(2):
        params, rs, m = rstep(params, rs, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    assert len(got) == 2
    assert_close(np.float32(got[0][0]), np.float32(want[0][0]), dtype="float32")
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 2e-3 * abs(wl) and abs(gn - wn) <= 2e-3 * abs(wn), (got, want)


def test_sharded_train_refuses_a_shard_data_model(run):
    """shard_data splits each call's rows over the activation mesh, which
    needs the same rows on every rank; the sharded loop gives each rank its
    own, so it raises instead of computing wrong numbers."""
    msg = _case(run, "mace_train")[True]
    assert isinstance(msg, str) and msg.startswith("ValueError") and "shard_data" in msg


def test_checkpoint_on_one_mesh_resumes_on_another(run, lm_reference):
    """Steps 1-2 on (2, 1) with a checkpoint each, resumed on (1, 2) for
    step 3: the loss and parameters of the uninterrupted reference run."""
    res = _case(run, "elastic_resume")
    _check_lm(res["first"], lm_reference, steps=(1, 2))
    _check_lm(res["second"], lm_reference, steps=(3,))
    train = _case(run, "train")["2x1"]
    for k, p in train["params"].items():
        assert_close(res["second"]["params"][k], p, dtype="float32")


def _quant_np(x):
    scale = np.float32(max(float(np.abs(x).max()), 1e-8) / 127.0)
    q = np.clip(np.round(x / scale), -127, 127)
    return q.astype(np.float32) * scale


def test_int8_ef_pod2_matches_numpy_formula(run):
    """Each rank's own gradient and residual: the reduced mean is the same
    on both, each keeps its own new residual."""
    res = _case(run, "int8", same=False)
    _same(res["pod2"][0], run[1]["int8"]["pod2"][0])
    a = run[2]
    for name, key, e0 in (("a", "q_g", a["q_e"]), ("b", "q_h", None)):
        xs = [a[key][r] + (e0[r] if e0 is not None else 0) for r in range(WORLD)]
        deq = [_quant_np(x) for x in xs]
        out, ef = res["pod2"]
        np.testing.assert_allclose(out[name].numpy(), (deq[0] + deq[1]) / 2, rtol=1e-6,
                                   atol=1e-6)
        # each rank keeps its own residual; rank 0's is in rank 0's result
        np.testing.assert_allclose(run[0]["int8"]["pod2"][1][name].numpy(), xs[0] - deq[0],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(run[1]["int8"]["pod2"][1][name].numpy(), xs[1] - deq[1],
                                   rtol=1e-6, atol=1e-6)


def test_int8_ef_pod1_matches_reference(run):
    """pod=1 (each rank alone in its pod): the reference's call on a
    one-device ('pod', 'data', 'model') mesh, from rank 0's gradient; and a
    mesh with no 'pod' axis is the identity."""
    _case(run, "int8", same=False)
    for r in range(WORLD):
        res = run[r]["int8"]
        a = run[2]
        g = {"a": _j(a["q_g"][r]), "b": _j(a["q_h"][r])}
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                                 ("pod", "data", "model"))
        out, ef = ref_int8(g, jax.tree.map(jnp.zeros_like, g), mesh)
        for k in ("a", "b"):
            np.testing.assert_allclose(res["pod1"][0][k].numpy(), np.asarray(out[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(res["pod1"][1][k].numpy(), np.asarray(ef[k]),
                                       rtol=1e-5, atol=1e-7)
            assert torch.equal(res["no_pod"][0][k], torch.as_tensor(a["q_g" if k == "a"
                                                                      else "q_h"][r]))


def _int8_reference(port_ef: list):
    """The compressed step on a (2, 1, 1) ('pod', 'data', 'model') mesh,
    written plainly, for ``len(port_ef)`` steps: each pod's gradient (its
    rows' mean loss, by the reference's ``jax.grad``) plus its residual,
    put on the int8 grid of one absmax/127 scale a port leaf; the mean over
    the pods; the reference's clip and AdamW.  The two sides' gradients
    differ at the gradient tier, so a value near a rounding tie may round
    either way: the grid point of each element is the port's (read off
    ``port_ef[step][pod]``, the port's residual after that step), and the
    test checks that it is a nearest one.  -> (params, [per step, per pod:
    (residual, scale)]), port-keyed numpy."""
    jcfg, jm, params = _lm_ref()
    tc = JTrainConfig(total_steps=len(port_ef), **LM_TCFG)
    opt = jadamw(jcosine(tc.lr, tc.warmup_steps, tc.total_steps), tc.b1, tc.b2, tc.eps,
                 tc.weight_decay)
    state = opt.init(params)
    pipe = JPipeline(vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=0)
    grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))

    def to_port(tree):
        return {k: v.numpy() for k, v in _flat(lm_params_from_jax(_np_tree(tree)))}

    # which port leaves each reference leaf splits into (a stacked leaf: one a layer)
    leaves0, tdef = jax.tree.flatten(params)
    ids = to_port(jax.tree.unflatten(tdef, [np.full(a.shape, i, np.float32)
                                            for i, a in enumerate(leaves0)]))
    parts: dict = {}
    for k, v in ids.items():
        parts.setdefault(int(v.reshape(-1)[0]), []).append(k)

    def to_ref(port):
        return jax.tree.unflatten(tdef, [
            jnp.asarray(np.stack([port[k] for k in parts[i]]).reshape(a.shape))
            for i, a in enumerate(leaves0)])

    ef = [{k: np.zeros_like(v) for k, v in ids.items()} for _ in range(WORLD)]
    steps = []
    for port in port_ef:
        batch = pipe.next_batch()
        deq, out = [], []
        for r in range(WORLD):  # rank r is pod r; its rows are the r-th half
            rows = {k: jnp.asarray(v[2 * r: 2 * r + 2]) for k, v in batch.items()}
            d_r, scales = {}, {}
            for k, g in to_port(grad(params, rows)).items():
                x = g + ef[r][k]
                scale = np.float32(max(float(np.abs(x).max()), 1e-8) / 127.0)
                q = np.clip(np.round((x - port[r][k].numpy()) / scale), -127, 127)
                d_r[k] = q.astype(np.float32) * scale
                ef[r][k], scales[k] = x - d_r[k], scale
            deq.append(d_r)
            out.append(({k: v.copy() for k, v in ef[r].items()}, scales))
        steps.append(out)
        g, _ = jclip(to_ref({k: (deq[0][k] + deq[1][k]) / WORLD for k in ids}), tc.grad_clip)
        upd, state = opt.update(g, state, params)
        params = japply_updates(params, upd)
    return to_port(params), steps


def test_int8_ef_in_the_sharded_train_step(run, lm_reference):
    """grad_compression='int8_ef' on a (2, 1, 1) ('pod', 'data', 'model')
    mesh against `_int8_reference`, after each of two steps, each pod and
    leaf: the port's residual is within half a quantization step (it
    rounded its value to a nearest grid point), equals the reference's
    value less that grid point at the gradient tier (2e-3 of the leaf's
    scale) and is not zero; after step 2 the parameters at 2e-3 of each
    leaf's scale.  Both ranks hold the same parameters and loss."""
    res = [run[r]["int8"] for r in range(WORLD)]
    for r in res:
        assert "error" not in r and r["train_int8"]["steps"] == [1, 2]
    _same(res[0]["train_int8"]["params"], res[1]["train_int8"]["params"])
    assert res[0]["train_int8"]["loss"] == res[1]["train_int8"]["loss"]
    port_ef = [[res[r][name]["ef"] for r in range(WORLD)]
               for name in ("train_int8_1", "train_int8")]
    want_p, steps = _int8_reference(port_ef)
    for port, want in zip(port_ef, steps):
        for r in range(WORLD):
            ef_ref, scales = want[r]
            for k, w in ef_ref.items():
                got, s = port[r][k].numpy(), float(scales[k])
                # half the port's step: its absmax is the reference's at the gradient tier
                assert float(np.abs(got).max()) <= 0.5 * s * (1 + 2e-3), (r, k)
                assert float(np.abs(got - w).max()) <= 2e-3 * 127 * s, (r, k)
                assert float(np.abs(got).max()) > 0.25 * s, (r, k)
    for k, w in want_p.items():
        got = res[0]["train_int8"]["params"][k].numpy()
        assert_close(got, w, tol=2e-3 * float(np.abs(w).max()) + 1e-4)
    # the uncompressed run on the same mesh is the reference's plain loop
    _check_lm(res[0]["train_none"], lm_reference, steps=(1, 2))


def test_checkpoint_elastic_reshard(run):
    """Twin of test_training_substrate.py::test_checkpoint_elastic_reshard:
    saved whole, restored with explicit placements on the (2, 1) mesh."""
    full, local, pl = _case(run, "elastic_twins", same=False)["reshard"]
    np.testing.assert_array_equal(full.numpy(), np.arange(16.0).reshape(4, 4))
    assert tuple(local.shape) == (2, 4) and pl == ["S(0)", "R"]
    assert not torch.equal(run[0]["elastic_twins"]["reshard"][1],
                           run[1]["elastic_twins"]["reshard"][1])


def test_elastic_reshard_live_tree(run):
    res = _case(run, "elastic_twins", same=False)
    _same(res["live"], run[1]["elastic_twins"]["live"])
    scale, mesh_shape, pl = res["live"]
    np.testing.assert_array_equal(scale.numpy(), np.ones(8))
    assert mesh_shape == (2, 1) and pl == ["S(0)", "R"]


def test_elastic_restore_on_mesh(run):
    got = _case(run, "elastic_twins", same=False)["restore_on_mesh"]
    _same(got, run[1]["elastic_twins"]["restore_on_mesh"])
    np.testing.assert_array_equal(got.numpy(), np.arange(32.0).reshape(4, 8))


def test_launcher_under_torchrun(tmp_path):
    """The training launcher with --mesh-data 2 under torchrun (gloo, two
    processes on this host): it trains and rank 0 logs each step."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(29500 + os.getpid() % 1000),
         "-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b", "--reduced", "--device",
         "cpu", "--mesh-data", "2", "--steps", "2", "--seq", "16", "--batch", "2",
         "--log-every", "1", "--ckpt", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.count("[train] step") == 2, out.stdout
    assert "mesh=(2, 1)" in out.stdout and "done at step 2" in out.stdout
    assert (tmp_path / "step_2" / "COMMITTED").exists()
