"""The port's Zamba2 hybrid language model against the JAX reference at
``get_config("zamba2-2.7b").reduced()`` (d 128, 6 Mamba-2 layers in 3
stages of 2, 16 SSD heads of 16, state 16, a shared attention block of 4
heads of 32, GeGLU, vocab 512, f32): the config, RoPE, the MLPs, the three
attention paths, the Mamba-2 mixer (sequence and decode step), forward
(full attention at S = 32, the flash path at S = 128), prefill (logits and
every cache leaf) and decode_step, on parameters converted from the
reference's ``init`` tree, at the f32 identity tier (3e-4 scale-relative),
and one bf16 forward at the bf16 tier (5e-2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import count_params as jcount_params
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.testing import assert_close
from repro_torch.config import get_config, list_configs
from repro_torch.models import attention, layers, ssm
from repro_torch.models.api import build_model, count_params
from repro_torch.models.convert import lm_params_from_jax

B = 2
S_LONG = 128  # > attn_chunk (64): the flash path, 2 x 2 tiles


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S_LONG + 64)).astype(np.int32)
    return jcfg, cfg, jm, jparams, build_model(cfg, device="cpu"), params, tokens


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["mamba"])


def test_config_matches_reference():
    for full in (True, False):
        j, p = jget_config("zamba2-2.7b"), get_config("zamba2-2.7b")
        if not full:
            j, p = j.reduced(), p.reduced()
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
    red = get_config("zamba2-2.7b").reduced()
    assert (red.n_layers, red.attn_every, red.d_model, red.ssm_headdim, red.ssm_state) == \
        (6, 2, 128, 16, 16)
    assert "zamba2-2.7b" in list_configs()


def test_count_params_matches_reference():
    cfg = get_config("zamba2-2.7b")
    assert count_params(cfg) == 2_435_777_440 == jcount_params(jget_config("zamba2-2.7b"))
    assert count_params(cfg.reduced()) == jcount_params(jget_config("zamba2-2.7b").reduced())


def test_converted_tree_has_reference_names(setup):
    _, cfg, _, jparams, _, params, _ = setup
    assert set(params) == set(jparams) == {"embed", "ln_f", "unembed", "mamba", "shared",
                                           "cat_proj"}
    assert len(params["mamba"]) == cfg.n_layers
    for tree, jtree in ((params["mamba"][0], _layer0(jparams)),
                        (params["shared"], jparams["shared"])):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            node = tree
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape
    assert tuple(params["cat_proj"]["w"].shape) == jparams["cat_proj"]["w"].shape


@pytest.mark.parametrize("frac,dtype", [(1.0, "float32"), (0.5, "float32"),
                                        (1.0, "bfloat16")])
def test_rope_matches_reference(frac, dtype):
    x = _x((2, 40, 3, 32), 1)
    pos = np.random.default_rng(2).integers(0, 4096, (2, 40)).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x, dtype), jnp.asarray(pos), 10000.0, frac)
    got = layers.rope(_t(x).to(getattr(torch, dtype)), _t(pos), 10000.0, frac)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype=dtype)


@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu_mlp"])
def test_mlp_apply_matches_reference(act):
    jp = jlayers.mlp_init(jax.random.PRNGKey(3), 32, 64, act)
    p = jax.tree.map(lambda a: _t(a), jax.tree.map(np.asarray, jp))
    x = _x((2, 5, 32), 4)
    assert set(p) == set(jp)
    assert_close(layers.mlp_apply(p, _t(x), act).numpy(),
                 np.asarray(jlayers.mlp_apply(jp, jnp.asarray(x), act)))


@pytest.mark.parametrize("kv,causal", [(4, True), (2, True), (2, False)])
def test_full_attention_matches_reference(kv, causal):
    q, k, v = _x((2, 24, 4, 16), 5), _x((2, 24, kv, 16), 6), _x((2, 24, kv, 16), 7)
    got = attention.full_attention(_t(q), _t(k), _t(v), causal=causal)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T,kv", [(128, 4), (128, 2), (96, 4)])
def test_blockwise_attention_matches_reference(T, kv):
    """2 x 2 tiles of 64 (the masked one included); T = 96 is not a multiple
    of the tile and falls back to full attention, as in the reference."""
    q, k, v = _x((2, T, 4, 16), 8), _x((2, T, kv, 16), 9), _x((2, T, kv, 16), 10)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), q_chunk=64, kv_chunk=64)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     q_chunk=64, kv_chunk=64)
    assert_close(got.numpy(), np.asarray(want))
    assert_close(got.numpy(), attention.full_attention(_t(q), _t(k), _t(v)).numpy())


def test_decode_attention_matches_reference():
    q, kc, vc = _x((3, 1, 4, 16), 11), _x((3, 20, 2, 16), 12), _x((3, 20, 2, 16), 13)
    pos = np.array([0, 7, 19], np.int32)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(pos))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(pos))
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T", [32, S_LONG])
def test_mamba2_apply_matches_reference(setup, T):
    jcfg, cfg, _, jparams, _, params, _ = setup
    jp, p = _layer0(jparams)["m"], params["mamba"][0]["m"]
    x = _x((B, T, cfg.d_model), 14)
    out, st = ssm.mamba2_apply(p, _t(x), cfg, return_state=True)
    assert_close(out.numpy(), np.asarray(jssm.mamba2_apply(jp, jnp.asarray(x), jcfg)))
    assert torch.equal(ssm.mamba2_apply(p, _t(x), cfg), out)
    assert st["conv"].shape == (B, cfg.ssm_conv - 1, 2 * cfg.d_model + 2 * cfg.ssm_state)


def test_mamba2_decode_step_matches_reference(setup):
    jcfg, cfg, _, jparams, _, params, _ = setup
    jp, p = _layer0(jparams)["m"], params["mamba"][0]["m"]
    proto = jssm.mamba2_state_init(jcfg, B)
    jst = {k: jnp.asarray(_x(a.shape, 15 + i)) for i, (k, a) in enumerate(proto.items())}
    x = _x((B, 1, cfg.d_model), 18)
    jy, jnew = jssm.mamba2_decode_step(jp, jnp.asarray(x), jst, jcfg)
    y, new = ssm.mamba2_decode_step(p, _t(x), {k: _t(a) for k, a in jst.items()}, cfg)
    assert_close(y.numpy(), np.asarray(jy))
    for k in jnew:
        assert_close(new[k].numpy(), np.asarray(jnew[k]))


@pytest.mark.parametrize("S", [32, S_LONG])
def test_forward_matches_reference(setup, S):
    _, cfg, jm, jparams, m, params, tokens = setup
    jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    logits, aux = m.forward(params, {"tokens": tokens[:, :S]})
    assert logits.shape == (B, S, cfg.vocab) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    assert_close(logits.numpy(), np.asarray(jlogits))


def test_forward_bf16_matches_reference():
    """The bf16 path rounds where the reference rounds: one stage (2 Mamba-2
    layers and the shared block) in bf16 compute against the reference's,
    at the bf16 identity tier (5e-2)."""
    jcfg = jget_config("zamba2-2.7b").reduced(dtype="bfloat16", n_layers=2)
    cfg = get_config("zamba2-2.7b").reduced(dtype="bfloat16", n_layers=2)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S_LONG)).astype(np.int32)
    jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits, _ = build_model(cfg, device="cpu").forward(params, {"tokens": tokens})
    assert_close(logits.numpy(), np.asarray(jlogits), dtype="bfloat16")


@pytest.mark.parametrize("S", [32, S_LONG])
def test_prefill_and_decode_match_reference(setup, S):
    """prefill's last logits and every cache leaf, then one decode step."""
    _, cfg, jm, jparams, m, params, tokens = setup
    max_len = S + 8
    jlast, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])}, max_len)
    last, cache = m.prefill(params, {"tokens": tokens[:, :S]}, max_len)
    assert last.shape == (B, 1, cfg.vocab)
    assert_close(last.numpy(), np.asarray(jlast))
    assert set(cache) == set(jcache) == {"mamba", "k", "v"}
    assert set(cache["mamba"]) == set(jcache["mamba"]) == {"conv", "ssm"}
    leaves = [(cache["mamba"][n], jcache["mamba"][n]) for n in ("conv", "ssm")]
    leaves += [(cache[n], jcache[n]) for n in ("k", "v")]
    for got, want in leaves:
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert_close(got.numpy(), np.asarray(want))
    pos = np.full((B,), S, np.int32)
    tok = tokens[:, S:S + 1]
    jstep, jc2 = jm.decode_step(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
    step, c2 = m.decode_step(params, cache, tok, torch.from_numpy(pos))
    assert_close(step.numpy(), np.asarray(jstep))
    for n in ("conv", "ssm"):
        assert_close(c2["mamba"][n].numpy(), np.asarray(jc2["mamba"][n]))
    for n in ("k", "v"):
        assert_close(c2[n].numpy(), np.asarray(jc2[n]))


def test_prefill_then_decode_reproduces_forward(setup):
    """The port's own consistency: decode of token S after a prefill of S
    equals forward over S + 64 tokens (whole chunks) read at S, by
    causality; prefill's last logits are forward's at S - 1."""
    _, _, _, _, m, params, tokens = setup
    full, _ = m.forward(params, {"tokens": tokens})
    last, cache = m.prefill(params, {"tokens": tokens[:, :S_LONG]}, S_LONG + 1)
    assert_close(last[:, 0].numpy(), full[:, S_LONG - 1].numpy())
    step, _ = m.decode_step(params, cache, tokens[:, S_LONG:S_LONG + 1],
                            torch.full((B,), S_LONG))
    assert_close(step[:, 0].numpy(), full[:, S_LONG].numpy())


def test_decode_step_leaves_the_callers_cache(setup):
    """decode_step is functional, as the reference's: the returned cache
    holds the new token's k and v at pos, and the cache passed in, Mamba
    states and KV cache alike, is left as it was."""
    _, _, _, _, m, params, tokens = setup
    S = 32
    _, cache = m.prefill(params, {"tokens": tokens[:, :S]}, S + 4)
    before = {"conv": cache["mamba"]["conv"].clone(), "ssm": cache["mamba"]["ssm"].clone(),
              "k": cache["k"].clone(), "v": cache["v"].clone()}
    _, c2 = m.decode_step(params, cache, tokens[:, S:S + 1], torch.full((B,), S))
    now = {"conv": cache["mamba"]["conv"], "ssm": cache["mamba"]["ssm"], "k": cache["k"],
           "v": cache["v"]}
    for n, a in before.items():
        assert torch.equal(now[n], a), n
    for n in ("k", "v"):
        assert c2[n] is not cache[n]
        assert torch.equal(c2[n][:, :, :S], cache[n][:, :, :S])
        assert not torch.equal(c2[n][:, :, S], cache[n][:, :, S])
        assert torch.equal(c2[n][:, :, S + 1:], cache[n][:, :, S + 1:])


def test_forward_rejects_ragged_chunks(setup):
    """Past one chunk the scan takes whole chunks of 64, as the reference
    asserts: forward over 100 tokens raises."""
    _, _, _, _, m, params, tokens = setup
    with pytest.raises(ValueError, match="multiple of the chunk"):
        m.forward(params, {"tokens": tokens[:, :100]})


def test_init_cache_layout_matches_reference(setup):
    _, _, jm, _, m, _, _ = setup
    jc = jm.init_cache(3, 16)
    c = m.init_cache(3, 16)
    pairs = [(c["mamba"][n], jc["mamba"][n]) for n in ("conv", "ssm")]
    pairs += [(c[n], jc[n]) for n in ("k", "v")]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not got.any()


def test_port_init_has_reference_shapes_and_is_seeded():
    cfg = get_config("zamba2-2.7b").reduced()
    m = build_model(cfg, device="cpu")
    p1 = m.init(torch.Generator().manual_seed(3))
    p2 = m.init(torch.Generator().manual_seed(3))
    jshapes = jax.eval_shape(lambda: jbuild_model(jget_config("zamba2-2.7b").reduced())
                             .init(jax.random.PRNGKey(0)))
    jl = jax.tree.map(lambda a: a.shape[1:], jshapes["mamba"])
    assert len(p1["mamba"]) == cfg.n_layers
    for lp, lp2 in zip(p1["mamba"], p2["mamba"]):
        torch.testing.assert_close(lp["m"]["in_proj"]["w"], lp2["m"]["in_proj"]["w"])
        assert tuple(lp["m"]["in_proj"]["w"].shape) == jl["m"]["in_proj"]["w"]
        assert tuple(lp["m"]["conv_w"].shape) == jl["m"]["conv_w"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes["shared"])[0]:
        node = p1["shared"]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
    torch.testing.assert_close(p1["mamba"][0]["m"]["A_log"],
                               torch.log(torch.linspace(1.0, 8.0, 16)))
