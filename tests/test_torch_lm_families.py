"""The port's attention families (dense, moe, vlm, encdec) against the JAX
reference, at each arch's ``reduced()`` config in f32 (2 layers, d 128, 4
heads of 32, vocab 512; MoE 4 experts top-2; M-RoPE sections (4, 6, 6);
Whisper 2 + 2 layers over 64 source frames): the configs, M-RoPE, forward
logits and MoE aux loss, prefill's last logits and every cache leaf, one
decode step, the reference's prefill/decode consistency test, the exact
parameter counts of all ten full configs, `lm_params_from_jax` for every
family, and `decode_step` leaving the caller's cache as it was.  The
parameters are converted from the reference's ``init``; every comparison is
at the f32 identity tier (3e-4, scale-relative)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.configs import ALL_LM_ARCHS as JALL, SUBQUADRATIC as JSUB
from repro.models import build_model as jbuild_model
from repro.models import count_params as jcount_params
from repro.models import layers as jlayers
from repro.testing import assert_close
from repro_torch.config import get_config
from repro_torch.configs import ALL_LM_ARCHS, SUBQUADRATIC
from repro_torch.models import layers, transformer
from repro_torch.models.api import build_model, count_params
from repro_torch.models.convert import lm_params_from_jax

NEW_ARCHS = ["qwen2-0.5b", "qwen2-moe-a2.7b", "gemma-2b", "stablelm-3b", "qwen1.5-32b",
             "dbrx-132b", "qwen2-vl-72b", "whisper-base"]
FAMILY_ARCH = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b", "vlm": "qwen2-vl-72b",
               "encdec": "whisper-base", "ssm": "rwkv6-3b", "hybrid": "zamba2-2.7b"}
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _setup(arch: str, **over):
    jcfg = jget_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    return cfg, jm, jparams, build_model(cfg, device="cpu"), params


def _batch(cfg, T: int = S, seed: int = 0, positions3: str = "grid"):
    """Seeded tokens [B,T] (+ positions3 for vlm: a grid with its three axes
    apart, or text-like t = h = w; + source frames for encdec)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "vlm":
        t = np.arange(T)
        axes = [t // 8, (t // 4) % 2, t % 4] if positions3 == "grid" else [t] * 3
        b["positions3"] = np.stack(axes, -1)[None].repeat(B, 0).astype(np.int32)
    if cfg.family == "encdec":
        b["source_embeds"] = rng.normal(size=(B, cfg.max_source_len,
                                              cfg.d_model)).astype(np.float32)
    return b


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree, prefix=()):
    """(path, tensor) of nested dicts (sorted by key) and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, prefix + (i,))
    else:
        yield prefix, tree


def _np(a):
    return np.asarray(a.float() if a.dtype != torch.int8 else a)


def _assert_cache_close(cache, jcache):
    got = dict(_leaves(cache))
    want = {tuple(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert set(got) == set(want)
    for k, a in got.items():
        assert tuple(a.shape) == want[k].shape, k
        assert_close(_np(a), np.asarray(want[k], np.float32))


def test_configs_match_reference():
    assert ALL_LM_ARCHS == JALL and SUBQUADRATIC == JSUB
    for arch in ALL_LM_ARCHS:
        for full in (True, False):
            j, p = jget_config(arch), get_config(arch)
            if not full:
                j, p = j.reduced(), p.reduced()
            assert dataclasses.asdict(p) == dataclasses.asdict(j), arch


def test_count_params_matches_reference_for_every_config():
    """Exact counts of all ten full configs (the port sizes on the meta
    device; nothing is allocated), and the reduced ones."""
    for arch in ALL_LM_ARCHS:
        assert count_params(get_config(arch)) == jcount_params(jget_config(arch)), arch
        assert count_params(get_config(arch).reduced()) == \
            jcount_params(jget_config(arch).reduced()), arch
    assert count_params(get_config("dbrx-132b")) > 125e9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_mrope_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, 3, 32)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 24, 3)).astype(np.int32)
    want = jlayers.rope_mrope(jnp.asarray(x, dtype), jnp.asarray(pos3), 1e6, (4, 6, 6))
    got = layers.rope_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos3), 1e6, (4, 6, 6))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype=dtype)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_reference(arch):
    cfg, jm, jparams, model, params = _setup(arch)
    batch = _batch(cfg)
    want, jaux = jax.jit(jm.forward)(jparams, _j(batch))
    with torch.no_grad():
        got, aux = model.forward(params, batch)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want))
    assert_close(aux.numpy(), np.asarray(jaux))
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base"])
def test_forward_flash_path_matches_reference(arch):
    """128 tokens > attn_chunk (64): self attention on the flash path, and
    Whisper's cross attention over 64 frames on it too."""
    cfg, jm, jparams, model, params = _setup(arch)
    batch = _batch(cfg, T=128, seed=1)
    want, _ = jax.jit(jm.forward)(jparams, _j(batch))
    with torch.no_grad():
        got, _ = model.forward(params, batch)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_matches_reference(arch):
    """The last logits and every cache leaf (k after RoPE, v; encdec the
    cross keys and values over the source)."""
    cfg, jm, jparams, model, params = _setup(arch)
    batch = _batch(cfg, positions3="text")
    want, jcache = jax.jit(lambda p, b: jm.prefill(p, b, S + 8))(jparams, _j(batch))
    with torch.no_grad():
        got, cache = model.prefill(params, batch, S + 8)
    assert got.shape == (B, 1, cfg.vocab)
    assert_close(got.numpy(), np.asarray(want))
    _assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_step_matches_reference(arch):
    """One decode step from the reference's own prefilled cache, converted."""
    cfg, jm, jparams, model, params = _setup(arch)
    batch = _batch(cfg, positions3="text")
    _, jcache = jax.jit(lambda p, b: jm.prefill(p, b, S + 8))(jparams, _j(batch))
    cache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcache)
    tok, pos = batch["tokens"][:, 3:4], np.array([S, S - 5], np.int32)
    want, jnew = jax.jit(jm.decode_step)(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
    with torch.no_grad():
        got, new = model.decode_step(params, cache, tok, pos)
    assert_close(got.numpy(), np.asarray(want))
    _assert_cache_close(new, jnew)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_consistency(arch):
    """The twin of the reference's test_arch_smoke.py test: decode_step after
    prefill reproduces forward's logits at the next position (lossless MoE
    capacity), here at the f32 tier."""
    cfg, _, _, model, params = _setup(arch, capacity_factor=8.0)
    batch = _batch(cfg, T=S + 1, seed=1, positions3="text")
    with torch.no_grad():
        logits_all, _ = model.forward(params, batch)
        pre = {k: (v[:, :S] if k in ("tokens", "positions3") else v) for k, v in batch.items()}
        last, cache = model.prefill(params, pre, S + 8)
        step, _ = model.decode_step(params, cache, batch["tokens"][:, S:], np.full(B, S))
    assert_close(last[:, 0].numpy(), logits_all[:, S - 1].numpy())
    assert_close(step[:, 0].numpy(), logits_all[:, S].numpy())


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_lm_params_from_jax_every_family(family):
    """The converted tree has the port's own names and shapes (its ``init``
    on the meta device), and each layer's leaves are that layer's slice of
    the reference's stacked tree (experts stay stacked inside the layer)."""
    arch = FAMILY_ARCH[family]
    cfg, _, jparams, _, params = _setup(arch)
    own = transformer.init_params(None, cfg, torch.device("meta"))
    assert [(k, tuple(a.shape)) for k, a in _leaves(params)] == \
        [(k, tuple(a.shape)) for k, a in _leaves(own)]
    stacked = [k for k in ("layers", "enc_layers", "mamba") if k in jparams]
    assert stacked and all(len(params[k]) == len(jax.tree.leaves(jparams[k])[0]) for k in stacked)
    for k in stacked:
        for i, lp in enumerate(params[k]):
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams[k])[0]:
                node = lp
                for key in path:
                    node = node[key.key]
                np.testing.assert_array_equal(node.numpy(), np.asarray(leaf)[i])
    if family == "moe":
        assert tuple(params["layers"][0]["moe"]["we_gate"].shape) == (4, 128, 128)
    if family == "encdec":
        np.testing.assert_array_equal(params["dec_pos"].numpy(), np.asarray(jparams["dec_pos"]))


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH) + ["int8"])
def test_decode_step_leaves_callers_cache_unchanged(family):
    """decode_step is functional, as in the reference: it returns a new cache
    with the token written and the caller's cache as it was; the in-place
    step writes the same values into the cache it is given."""
    arch = "gemma-2b" if family == "int8" else FAMILY_ARCH[family]
    over = {"kv_cache_dtype": "int8"} if family == "int8" else {}
    cfg, _, _, model, params = _setup(arch, **over)
    batch = _batch(cfg, T=8, positions3="text")
    with torch.no_grad():
        _, cache = model.prefill(params, batch, 16)
        before = [a.clone() for _, a in _leaves(cache)]
        logits, new = model.decode_step(params, cache, batch["tokens"][:, :1], np.full(B, 8))
        assert all(torch.equal(a, b) for (_, a), b in zip(_leaves(cache), before))
        assert any(not torch.equal(a, b) for (_, a), b in zip(_leaves(new), before))
        inplace = model.decode_step_inplace(params, cache, torch.as_tensor(
            batch["tokens"][:, :1], dtype=torch.long), torch.full((B,), 8))
    assert torch.equal(inplace, logits)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(cache), _leaves(new)))


def test_forward_takes_stub_frontend_embeddings():
    """``embeds`` replaces the token embedding (a stub frontend), as in the
    reference."""
    cfg, jm, jparams, model, params = _setup("qwen2-vl-72b")
    batch = _batch(cfg)
    batch["embeds"] = np.random.default_rng(3).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want, _ = jax.jit(jm.forward)(jparams, _j(batch))
    with torch.no_grad():
        got, _ = model.forward(params, batch)
    assert_close(got.numpy(), np.asarray(want))
