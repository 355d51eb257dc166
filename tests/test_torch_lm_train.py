"""The language models' training path against the JAX reference:
per-block remat (no number changes, fewer saved bytes), `input_specs`, and
the train loop and launcher on `LMModule` (twins of
tests/test_training_substrate.py's train-loop tests, three steps against
the reference's `train_loop`).  The cross-entropies and the flash backward
are held in ``test_torch_lm_ce_flash.py``, the scans' training route in
``test_torch_lm_scan_grad.py``, `Model.loss` and its gradients in
``test_torch_lm_grad_a.py`` and ``_b.py``.  Tolerances: f32 identity 3e-4
for values, f32 loose 2e-3 for gradients (repro.testing.tol_for)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks

from repro.config import SHAPES as JSHAPES
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget_config
from repro.data import LMTokenPipeline as JPipeline
from repro.models import api as japi
from repro.models import build_model as jbuild_model
from repro.testing import assert_close
from repro.train import train_loop as jtrain_loop
from repro_torch.config import SHAPES, TrainConfig, get_config
from repro_torch.data import LMTokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.models.api import LMModule, build_model, input_specs
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.train import make_train_step, train_loop
from test_torch_lm_grad_a import lm_batch, pairs

FAMILY_ARCH = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b", "vlm": "qwen2-vl-72b",
               "encdec": "whisper-base", "ssm": "rwkv6-3b", "hybrid": "zamba2-2.7b"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


class _Saved:
    """Bytes of the distinct storages autograd saves while active, other
    than those of ``exclude`` (the parameters), and the largest saved
    tensor's element count."""

    def __init__(self, exclude=()):
        self.skip = {t.untyped_storage().data_ptr() for t in exclude}
        self.storages, self.max_numel = {}, 0

    def pack(self, t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in self.skip:
            self.storages[ptr] = t.untyped_storage().nbytes()
        self.max_numel = max(self.max_numel, t.numel())
        return t

    def hooks(self):
        return saved_tensors_hooks(self.pack, lambda t: t)

    @property
    def nbytes(self) -> int:
        return sum(self.storages.values())


# ---------------------------------------------------------------- remat


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _loss_grads(cfg, params, batch, exclude):
    module = LMModule(cfg, params)
    saved = _Saved(exclude)
    with saved.hooks():
        loss, met = module.loss(batch)
    loss.backward()
    return loss.detach(), met["aux"].detach(), [p.grad for p in api._leaves(module.tree())], saved


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "encdec"])
def test_remat_changes_no_number_and_saves_less(family):
    cfg = get_config(FAMILY_ARCH[family]).reduced()
    assert not cfg.remat
    batch = lm_batch(cfg)
    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    out = []
    for remat in (False, True):
        params = _clone(init)
        out.append(_loss_grads(dataclasses.replace(cfg, remat=remat), params, batch,
                               list(api._leaves(params))))
    (l0, a0, g0, s0), (l1, a1, g1, s1) = out
    assert abs(float(l0 - l1)) <= 1e-6 * max(1.0, abs(float(l0)))
    assert abs(float(a0 - a1)) <= 1e-6 * max(1.0, abs(float(a0)))
    for x, y in zip(g0, g1):
        assert float((x - y).abs().max()) <= 1e-6 * max(1.0, float(x.abs().max()))
    assert s1.nbytes < s0.nbytes, (s1.nbytes, s0.nbytes)


# ---------------------------------------------------------------- input specs


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_input_specs_match_reference(family):
    """The meta-device stand-ins have the reference's shapes for every step
    kind, with int64 ids (the port's) where the reference has int32; the
    decode cache's dtypes are the reference's."""
    arch = FAMILY_ARCH[family]
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got, want = input_specs(cfg, SHAPES[name]), japi.input_specs(jcfg, JSHAPES[name])
        assert set(got) == set(want), name
        if name == "decode_32k":
            cache = dict(pairs(got["cache"], got["cache"]))
            jleaves = jax.tree.leaves(want["cache"])
            tleaves = [t for t, _ in pairs(got["cache"], got["cache"])]
            assert len(cache) == len(jleaves)
            assert sorted((tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tleaves) == \
                sorted((tuple(j.shape), str(j.dtype)) for j in jleaves)
            got, want = {k: got[k] for k in ("tokens", "pos")}, \
                {k: want[k] for k in ("tokens", "pos")}
        for k, t in got.items():
            assert t.device.type == "meta" and tuple(t.shape) == want[k].shape, (name, k)
            assert t.dtype == (torch.long if want[k].dtype == jnp.int32 else torch.float32)


# ---------------------------------------------------------------- train loop and launcher


def _tiny():
    """tests/test_training_substrate.py's tiny qwen2 (1 layer, d 64, vocab
    64, 2 heads of 32), its reference parameters and the port's module."""
    over = dict(n_layers=1, d_model=64, d_ff=128, vocab=64, n_heads=2, n_kv_heads=2,
                head_dim=32)
    jcfg, cfg = jget_config("qwen2-0.5b").reduced(**over), get_config("qwen2-0.5b").reduced(**over)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    module = LMModule(cfg, lm_params_from_jax(_np_tree(jparams)))
    return cfg, jm, jparams, module


def _pipe(cfg, seed=0):
    return LMTokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=seed)


def _loss_fn(m, batch):
    return m.loss(batch)


def test_lm_train_loop_loss_decreases(tmp_path):
    cfg, _, _, module = _tiny()
    tcfg = TrainConfig(lr=5e-3, warmup_steps=2, total_steps=12, checkpoint_every=6,
                       log_every=1)
    state, hist = train_loop(_loss_fn, module, _pipe(cfg), tcfg, ckpt_dir=str(tmp_path))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert state.step == 12
    assert {"loss", "ce", "aux", "grad_norm"} <= set(hist[0])


def test_lm_train_loop_resume_from_checkpoint(tmp_path):
    cfg, _, _, module = _tiny()
    tcfg = TrainConfig(lr=5e-3, warmup_steps=2, total_steps=6, checkpoint_every=3,
                       log_every=1)
    train_loop(_loss_fn, module, _pipe(cfg), tcfg, ckpt_dir=str(tmp_path))
    tcfg2 = dataclasses.replace(tcfg, total_steps=9)
    pipe2 = _pipe(cfg)
    state, hist = train_loop(_loss_fn, _tiny()[3], pipe2, tcfg2, ckpt_dir=str(tmp_path))
    assert state.step == 9 and [h["step"] for h in hist] == [7, 8, 9]
    assert pipe2.step == 9  # the pipeline's state resumed too


def test_lm_grad_accumulation_equivalence():
    """Two microbatches give the update of the whole batch (the loss is a
    mean; both halves hold the same number of labels)."""
    cfg = _tiny()[0]
    batch = {k: torch.as_tensor(v) for k, v in _pipe(cfg).next_batch().items()}
    out = []
    for mb in (0, 2):
        module = _tiny()[3]
        step, opt = make_train_step(_loss_fn, TrainConfig(lr=1e-3, warmup_steps=1,
                                                          total_steps=10, microbatch=mb))
        _, m = step(module, opt.init(dict(module.named_parameters())), batch)
        out.append((float(m["loss"]), [p.detach().clone() for p in module.parameters()]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    d = max(float((p - q).abs().max()) for p, q in zip(out[0][1], out[1][1]))
    assert d < 5e-3, d


def test_lm_train_loop_matches_reference():
    """Three steps of the reference's `train_loop` and the port's from the
    same parameters and token pipeline: the same loss at every step (f32
    identity tier); the gradient norms at the loose tier, since Adam's
    first steps move every parameter by about lr whatever its gradient's
    size, so gradients near zero that round apart move the next step's."""
    cfg, jm, jparams, module = _tiny()
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=3, log_every=1)
    _, jhist = jtrain_loop(jm.loss, jparams, JPipeline(vocab=cfg.vocab, seq_len=16,
                                                       global_batch=4, seed=0),
                           JTrainConfig(**kw), hooks={})
    _, hist = train_loop(_loss_fn, module, _pipe(cfg), TrainConfig(**kw),
                         hooks={"preemption": False})
    assert len(hist) == len(jhist) == 3
    for h, j in zip(hist, jhist):
        assert_close(np.float32(h["loss"]), np.float32(j["loss"]))
        assert_close(np.float32(h["grad_norm"]), np.float32(j["grad_norm"]), tier="loose")


def test_launcher_runs_on_cpu_and_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "3", "--device", "cpu",
            "--seq", "32", "--batch", "2", "--log-every", "1", "--ckpt", str(tmp_path),
            "--ckpt-every", "2", "--microbatch", "2"]
    hist = launch_train.run_once(launch_train.parser().parse_args(argv))
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert (tmp_path / "heartbeat.json").exists()
    argv[argv.index("--steps") + 1] = "4"
    assert launch_train.main(argv) == 0
    assert "[train] step 4 loss" in capsys.readouterr().out


def test_launcher_mesh_raises_item_10():
    """A mesh of two devices runs under torchrun with two processes; in a
    plain process (WORLD_SIZE unset) the launcher says so, before it joins
    any process group."""
    args = launch_train.parser().parse_args(["--arch", "qwen2-0.5b", "--reduced", "--device",
                                             "cpu", "--mesh-data", "2"])
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        launch_train.run_once(args)
