"""The port's RWKV6 language model against the JAX reference at
``get_config("rwkv6-3b").reduced()`` (d 128, 8 heads of 16, 2 layers, vocab
512, f32): the config, the time mix, the channel mix, a block, forward,
prefill (logits and every cache leaf) and decode_step, on parameters
converted from the reference's ``init`` tree, at the f32 identity tier
(3e-4 scale-relative)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as JSHAPES
from repro.config import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import count_params as jcount_params
from repro.models import ssm as jssm
from repro.models.layers import norm_apply as jnorm_apply
from repro.testing import assert_close
from repro_torch.config import SHAPES, get_config, list_configs
from repro_torch.models import ssm
from repro_torch.models.api import build_model, count_params
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.models.layers import norm_apply

B, S = 2, 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("rwkv6-3b").reduced()
    cfg = get_config("rwkv6-3b").reduced()
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return jcfg, cfg, jm, jparams, build_model(cfg, device="cpu"), params, tokens


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _layer0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["layers"])


def test_config_matches_reference():
    for full in (True, False):
        j = jget_config("rwkv6-3b")
        p = get_config("rwkv6-3b")
        if not full:
            j, p = j.reduced(), p.reduced()
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert "rwkv6-3b" in list_configs()
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_count_params_matches_reference():
    cfg = get_config("rwkv6-3b")
    assert count_params(cfg) == 3_099_776_000 == jcount_params(jget_config("rwkv6-3b"))
    assert count_params(cfg.reduced()) == jcount_params(jget_config("rwkv6-3b").reduced())


def test_converted_tree_has_reference_names(setup):
    _, cfg, _, jparams, _, params, _ = setup
    assert set(params) == set(jparams)
    assert len(params["layers"]) == cfg.n_layers
    flat = jax.tree_util.tree_flatten_with_path(_layer0(jparams))[0]
    for path, leaf in flat:
        node = params["layers"][0]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape


@pytest.mark.parametrize("T", [S, 1])
def test_time_mix_matches_reference(setup, T):
    """Sequence path (T = 32) and single step against a carried state (T = 1)."""
    jcfg, cfg, _, jparams, _, params, _ = setup
    jp, p = _layer0(jparams)["tm"], params["layers"][0]["tm"]
    x = _x((B, T, cfg.d_model), 1)
    if T == 1:
        H, K = cfg.d_model // cfg.rwkv_head_k, cfg.rwkv_head_k
        last_x, wkv = _x((B, cfg.d_model), 2), _x((B, H, K, K), 3)
        jout, jst = jssm.rwkv6_time_mix(jp, jnp.asarray(x), jcfg,
                                        state={"last_x": jnp.asarray(last_x),
                                               "wkv": jnp.asarray(wkv)})
        out, st = ssm.rwkv6_time_mix(p, torch.from_numpy(x), cfg,
                                     state={"last_x": torch.from_numpy(last_x),
                                            "wkv": torch.from_numpy(wkv)})
    else:
        jout, jst = jssm.rwkv6_time_mix(jp, jnp.asarray(x), jcfg)
        out, st = ssm.rwkv6_time_mix(p, torch.from_numpy(x), cfg)
    assert_close(out.numpy(), np.asarray(jout))
    for name in ("last_x", "wkv"):
        assert_close(st[name].numpy(), np.asarray(jst[name]))


@pytest.mark.parametrize("stateful", [False, True])
def test_channel_mix_matches_reference(setup, stateful):
    _, cfg, _, jparams, _, params, _ = setup
    jp, p = _layer0(jparams)["cm"], params["layers"][0]["cm"]
    T = 1 if stateful else S
    x = _x((B, T, cfg.d_model), 4)
    st = _x((B, cfg.d_model), 5) if stateful else None
    jout, jlast = jssm.rwkv6_channel_mix(jp, jnp.asarray(x),
                                         None if st is None else jnp.asarray(st))
    out, last = ssm.rwkv6_channel_mix(p, torch.from_numpy(x),
                                      None if st is None else torch.from_numpy(st))
    assert_close(out.numpy(), np.asarray(jout))
    if stateful:
        assert_close(last.numpy(), np.asarray(jlast))
    else:
        assert last is None and jlast is None


def test_block_and_decode_block_match_reference(setup):
    jcfg, cfg, _, jparams, _, params, _ = setup
    jp, p = _layer0(jparams), params["layers"][0]
    x = _x((B, S, cfg.d_model), 6)
    assert_close(ssm.rwkv6_apply(p, torch.from_numpy(x), cfg).numpy(),
                 np.asarray(jssm.rwkv6_apply(jp, jnp.asarray(x), jcfg)))
    jst = jssm.rwkv6_state_init(jcfg, B)
    jst = {k: jnp.asarray(_x(a.shape, 7 + i)) for i, (k, a) in enumerate(jst.items())}
    st = {k: torch.from_numpy(np.array(a)) for k, a in jst.items()}
    x1 = _x((B, 1, cfg.d_model), 10)
    jy, jnew = jssm.rwkv6_decode_step(jp, jnp.asarray(x1), jst, jcfg)
    y, new = ssm.rwkv6_decode_step(p, torch.from_numpy(x1), st, cfg)
    assert_close(y.numpy(), np.asarray(jy))
    for k in jnew:
        assert_close(new[k].numpy(), np.asarray(jnew[k]))


def test_norm_apply_matches_reference():
    x = _x((3, 5, 128), 11)
    p = {"scale": _x((128,), 12), "bias": _x((128,), 13)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for kind in ("layernorm", "rmsnorm"):
        jp = {k: jnp.asarray(v) for k, v in p.items() if kind == "layernorm" or k == "scale"}
        got = norm_apply({k: tp[k] for k in jp}, torch.from_numpy(x), kind)
        assert_close(got.numpy(), np.asarray(jnorm_apply(jp, jnp.asarray(x), kind)))


def test_forward_matches_reference(setup):
    _, cfg, jm, jparams, m, params, tokens = setup
    jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    logits, aux = m.forward(params, {"tokens": tokens[:, :S]})
    assert logits.shape == (B, S, cfg.vocab) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    assert_close(logits.numpy(), np.asarray(jlogits))


def test_forward_bf16_matches_reference():
    """The bf16 path rounds where the reference rounds: one layer in bf16
    compute against the reference's, at the bf16 identity tier (5e-2).
    (Deeper random-weight stacks amplify bf16 rounding in the reference
    too, so one layer is where the tier measures the casts.)"""
    jcfg = jget_config("rwkv6-3b").reduced(dtype="bfloat16", n_layers=1)
    cfg = get_config("rwkv6-3b").reduced(dtype="bfloat16", n_layers=1)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits, _ = build_model(cfg, device="cpu").forward(params, {"tokens": tokens})
    assert_close(logits.numpy(), np.asarray(jlogits), dtype="bfloat16")


def test_prefill_and_decode_match_reference(setup):
    """prefill's last logits and every cache leaf, then one decode step."""
    _, cfg, jm, jparams, m, params, tokens = setup
    jlast, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])}, S + 8)
    last, cache = m.prefill(params, {"tokens": tokens[:, :S]}, S + 8)
    assert last.shape == (B, 1, cfg.vocab)
    assert_close(last.numpy(), np.asarray(jlast))
    assert set(cache) == set(jcache) == {"last_x", "wkv", "cm_last_x"}
    for k in jcache:
        assert tuple(cache[k].shape) == jcache[k].shape
        assert_close(cache[k].numpy(), np.asarray(jcache[k]))
    pos = np.full((B,), S, np.int32)
    jstep, jc2 = jm.decode_step(jparams, jcache, jnp.asarray(tokens[:, S:]), jnp.asarray(pos))
    step, c2 = m.decode_step(params, cache, tokens[:, S:], torch.from_numpy(pos))
    assert_close(step.numpy(), np.asarray(jstep))
    for k in jc2:
        assert_close(c2[k].numpy(), np.asarray(jc2[k]))


def test_prefill_then_decode_reproduces_forward(setup):
    """The port's own consistency: decode after prefill gives forward's
    logits at the next position; prefill's last logits are forward's."""
    _, cfg, _, _, m, params, tokens = setup
    full, _ = m.forward(params, {"tokens": tokens})
    last, cache = m.prefill(params, {"tokens": tokens[:, :S]}, S + 1)
    assert_close(last[:, 0].numpy(), full[:, S - 1].numpy())
    step, _ = m.decode_step(params, cache, tokens[:, S:], torch.full((B,), S))
    assert_close(step[:, 0].numpy(), full[:, S].numpy())


def test_init_cache_layout_matches_reference(setup):
    jcfg, cfg, jm, _, m, _, _ = setup
    jc = jm.init_cache(3, 16)
    c = m.init_cache(3, 16)
    for k in jc:
        assert tuple(c[k].shape) == jc[k].shape
        assert str(c[k].dtype).split(".")[-1] == str(jc[k].dtype)
        assert not c[k].any()


def test_port_init_has_reference_shapes_and_is_seeded():
    cfg = get_config("rwkv6-3b").reduced()
    m = build_model(cfg, device="cpu")
    p1 = m.init(torch.Generator().manual_seed(3))
    p2 = m.init(torch.Generator().manual_seed(3))
    jshapes = jax.eval_shape(lambda: jbuild_model(jget_config("rwkv6-3b").reduced())
                             .init(jax.random.PRNGKey(0)))
    jl = jax.tree.map(lambda a: a.shape[1:], jshapes["layers"])
    for lp, lp2 in zip(p1["layers"], p2["layers"]):
        torch.testing.assert_close(lp["tm"]["wr"]["w"], lp2["tm"]["wr"]["w"])
        assert tuple(lp["cm"]["cm_k"]["w"].shape) == jl["cm"]["cm_k"]["w"]
        assert tuple(lp["tm"]["u"].shape) == jl["tm"]["u"]
    assert tuple(p1["unembed"]["w"].shape) == jshapes["unembed"]["w"].shape


def test_other_families_are_not_ported_yet():
    """Every family of the reference is ported now: each builds its
    parameters and its cache on the CPU (the attention families' layouts
    are held against the reference in test_torch_lm_families.py); an
    unknown family still raises."""
    cfg = get_config("rwkv6-3b").reduced()
    for family in ("dense", "moe", "vlm", "encdec"):
        c = get_config({"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b", "vlm": "qwen2-vl-72b",
                        "encdec": "whisper-base"}[family]).reduced()
        m = build_model(c, device="cpu")
        assert m.init(torch.Generator().manual_seed(0))["layers"]
        assert tuple(m.init_cache(1, 8)["k"].shape) == (c.n_layers, 1, 8, c.kv_heads, c.hd)
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(dataclasses.replace(cfg, family="nope"), device="cpu").init_cache(1, 8)