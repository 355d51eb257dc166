"""`Model.loss` and every parameter's gradient against the JAX reference
(the port's twin of tests/test_arch_smoke.py::test_forward_and_grad), at
each arch's ``reduced()`` config in f32 on a 2 x 32 batch: the total loss,
its cross-entropy and MoE aux parts at the f32 identity tier (3e-4,
scale-relative), each gradient leaf at the f32 loose tier (2e-3) relative
to the leaf's norm.  Parameters are converted from the reference's
``init``.  The reference's loss and gradients are computed once per arch;
the ten configs are split over this file and ``test_torch_lm_grad_b.py``
so that two workers share the reference's compiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.testing import assert_close
from repro_torch.config import get_config
from repro_torch.models.api import LMModule
from repro_torch.models.convert import lm_params_from_jax

ARCHS = ["dbrx-132b", "rwkv6-3b", "qwen2-0.5b", "gemma-2b", "stablelm-3b"]
B, S = 2, 32


def lm_batch(cfg, B=B, S=S, seed=0):
    """tests/test_arch_smoke.py's batch: seeded tokens and labels (+
    positions3 for vlm, source frames for encdec), numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["positions3"] = np.stack([np.arange(S)] * 3, -1)[None].repeat(B, 0).astype(np.int32)
    if cfg.family == "encdec":
        b["source_embeds"] = rng.normal(size=(B, cfg.max_source_len,
                                              cfg.d_model)).astype(np.float32)
    return b


def pairs(a, b):
    """(leaf, leaf) of two trees of the same structure."""
    if isinstance(a, dict):
        for k in a:
            yield from pairs(a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b):
            yield from pairs(x, y)
    else:
        yield a, b


def loss_and_grads(arch):
    """-> (the reference's loss, metrics and gradients, the port's after
    one `LMModule.loss` and backward on the converted parameters)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = lm_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jparams)
    module = LMModule(cfg, lm_params_from_jax(jax.tree.map(np.asarray, jparams)))
    loss, met = module.loss(batch)
    loss.backward()
    ref = (float(jloss), {k: float(v) for k, v in jmet.items()},
           lm_params_from_jax(jax.tree.map(np.asarray, jgrads)))
    return ref, (loss.detach(), {k: v.detach() for k, v in met.items()}, module)


def check_loss(ref, got):
    (jloss, jmet, _), (loss, met, _) = ref, got
    assert bool(torch.isfinite(loss))
    assert_close(loss.numpy(), np.float32(jloss))
    for k in ("ce", "aux"):
        assert_close(met[k].numpy(), np.float32(jmet[k]))


def check_grads(ref, got):
    grads, module = ref[2], got[2]
    n = 0
    for p, g in pairs(module.tree(), grads):
        assert p.grad is not None and p.grad.shape == g.shape
        err = float((p.grad - g).norm())
        assert err <= 2e-3 * max(float(g.norm()), 1e-12), (tuple(g.shape), err, float(g.norm()))
        n += 1
    assert n == len(list(module.parameters()))
    gn = float(torch.sqrt(sum(p.grad.square().sum() for p in module.parameters())))
    assert np.isfinite(gn) and gn > 0


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    return loss_and_grads(request.param)


def test_loss_matches_reference(twin):
    check_loss(*twin)


def test_grads_match_reference(twin):
    check_grads(*twin)
