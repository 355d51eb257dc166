"""The port's int8 KV cache against the JAX reference: `_quant_kv` bit for
bit on identical inputs (round half to even, the 1e-6 scale floor), the
int8 prefill cache and decode step against the reference's int8 ones on
converted parameters (f32 identity tier, 3e-4 scale-relative), and the
twins of both tests of ``tests/test_kv_int8.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer
from repro.testing import assert_close
from repro_torch.config import get_config
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.models.convert import lm_params_from_jax


@functools.lru_cache(maxsize=None)
def _setup(arch: str, seed: int, **over):
    """(port model, reference model, port params, reference params) of the
    reduced ``arch`` with ``over``, the parameters converted."""
    jm = jbuild_model(jget_config(arch).reduced(**over))
    jparams = jm.init(jax.random.PRNGKey(seed))
    return (build_model(get_config(arch).reduced(**over), device="cpu"), jm,
            lm_params_from_jax(jax.tree.map(np.asarray, jparams)), jparams)


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def test_quant_kv_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 32)).astype(np.float32) * rng.uniform(0.01, 50, (3, 5, 4, 1))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0                                       # the 1e-6 scale floor
    x[0, 0, 1, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]          # exact halves: to even
    x[0, 0, 1, 5:] = 0.25
    for a in (x, x.astype(jnp.bfloat16).astype(np.float32)):
        q, s = transformer._quant_kv(torch.from_numpy(a))
        jq, js = jtransformer._quant_kv(jnp.asarray(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float16
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q[0, 0, 1, :5].numpy(), [127, 0, 2, 2, 0])


def test_int8_prefill_and_decode_match_reference():
    model, jm, params, jparams = _setup("qwen2-0.5b", 0, kv_cache_dtype="int8")
    batch = _batch(model.cfg)
    B, S = batch["tokens"].shape
    jlast, jc = jax.jit(lambda p, b: jm.prefill(p, b, S + 8))(jparams, {"tokens": jnp.asarray(
        batch["tokens"])})
    with torch.no_grad():
        last, cache = model.prefill(params, batch, S + 8)
    assert_close(last.numpy(), np.asarray(jlast))
    assert set(cache) == set(jc) == {"k", "v", "k_scale", "v_scale"}
    for n in ("k", "v"):
        assert cache[n].dtype == torch.int8 and cache[n + "_scale"].dtype == torch.float16
        deq = cache[n].float() * cache[n + "_scale"].float()[..., None]
        jdeq = np.asarray(jc[n], np.float32) * np.asarray(jc[n + "_scale"], np.float32)[..., None]
        assert_close(deq.numpy(), jdeq)
        # the same rows quantized: a value may land one step over where the
        # k or v it rounds differs in its last bits
        assert int((cache[n].int() - torch.from_numpy(np.array(jc[n])).int()).abs().max()) <= 1
    tok, pos = batch["tokens"][:, :1], np.full((B,), S, np.int32)
    jlog, _ = jax.jit(jm.decode_step)(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
    with torch.no_grad():
        log, _ = model.decode_step(params, cache, tok, pos)
    assert_close(log.numpy(), np.asarray(jlog))


def test_int8_cache_decode_close_to_fp():
    """The twin of test_kv_int8.py's first test, on the port."""
    m_fp, _, params, _ = _setup("qwen2-0.5b", 0, capacity_factor=8.0)
    m_q8 = build_model(get_config("qwen2-0.5b").reduced(capacity_factor=8.0,
                                                        kv_cache_dtype="int8"), device="cpu")
    batch = _batch(m_fp.cfg)
    B, S = batch["tokens"].shape
    with torch.no_grad():
        _, c_fp = m_fp.prefill(params, batch, S + 8)
        _, c_q8 = m_q8.prefill(params, batch, S + 8)
        assert c_q8["k"].dtype == torch.int8
        fp_bytes = sum(a.numel() * a.element_size() for a in c_fp.values())
        q8_bytes = sum(a.numel() * a.element_size() for a in c_q8.values())
        assert q8_bytes < 0.55 * fp_bytes * (m_fp.cfg.hd + 2) / m_fp.cfg.hd
        pos = np.full((B,), S)
        tok = batch["tokens"][:, :1]
        log_fp, _ = m_fp.decode_step(params, c_fp, tok, pos)
        log_q8, _ = m_q8.decode_step(params, c_q8, tok, pos)
    assert float((log_fp - log_q8).abs().max()) < 0.5
    assert torch.equal(log_fp[:, 0].argmax(-1), log_q8[:, 0].argmax(-1))


def test_int8_cache_greedy_generation_matches():
    """The twin of test_kv_int8.py's second test: four greedy steps on the
    int8 cache reproduce the model-dtype cache's tokens."""
    m_fp, _, params, _ = _setup("gemma-2b", 1)
    m_q8 = build_model(get_config("gemma-2b").reduced(kv_cache_dtype="int8"), device="cpu")
    batch = _batch(m_fp.cfg, seed=2)
    B, S = batch["tokens"].shape
    outs = {}
    with torch.no_grad():
        for name, m in (("fp", m_fp), ("q8", m_q8)):
            last, cache = m.prefill(params, batch, S + 8)
            tok = last[:, 0].argmax(-1, keepdim=True)
            seq = [tok]
            for i in range(4):
                logits, cache = m.decode_step(params, cache, tok, np.full((B,), S + i))
                tok = logits[:, 0].argmax(-1, keepdim=True)
                seq.append(tok)
            outs[name] = torch.cat(seq, dim=1)
    assert torch.equal(outs["fp"], outs["q8"])
