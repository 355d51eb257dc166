"""The language models' cross-entropies and the flash attention backward
against the JAX reference: `softmax_cross_entropy`, the chunked
next-token CE (padding, ignored labels, tied, untied and soft-capped
heads; no saved [B,S,V] tensor), and the flash backward (twins of
tests/test_flash.py, the reference's custom VJP, and what the backward
saves).  Tolerances: f32 identity 3e-4 for values, f32 loose 2e-3 for
gradients (repro.testing.tol_for); the flash twins keep the reference
test's own 2e-5 / 3e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import transformer as jT
from repro.testing import assert_close
from repro_torch.config import get_config
from repro_torch.models import api, attention
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.models.flash import flash_attention_grouped
from test_torch_lm_grad_a import lm_batch
from test_torch_lm_train import _Saved, _np_tree, _t


# ---------------------------------------------------------------- cross-entropy


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[:, ::4] = -1
    want = japi.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = api.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long())
    assert_close(got.numpy(), np.asarray(want))
    assert float(api.softmax_cross_entropy(torch.zeros(1, 2, 3),
                                           torch.full((1, 2), -1))) == 0.0


@pytest.mark.parametrize("S", [33, 30])  # S - 1 a multiple of the chunk, and not
@pytest.mark.parametrize("arch,over", [("qwen2-0.5b", {}), ("qwen1.5-32b", {}),
                                       ("qwen2-0.5b", {"logit_softcap": 30.0})],
                         ids=["tied", "untied", "softcap"])
def test_chunked_cross_entropy_matches_reference(arch, over, S):
    """Value, and gradients with respect to h and the head (final norm and
    the tied embedding or the untied unembedding), with chunks of 8 and
    every fifth label ignored."""
    jcfg, cfg = jget_config(arch).reduced(**over), get_config(arch).reduced(**over)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    labels[:, ::5] = -1
    want, (jdh, jdp) = jax.value_and_grad(
        lambda h_, p_: jT.chunked_cross_entropy(p_, jcfg, h_, jnp.asarray(labels), chunk=8),
        argnums=(0, 1))(jnp.asarray(h), jparams)
    params = lm_params_from_jax(_np_tree(jparams))
    head = [params["ln_f"]["scale"],
            params["embed"]["embedding"] if cfg.tie_embeddings else params["unembed"]["w"]]
    for p in head:
        p.requires_grad_(True)
    ht = _t(h, grad=True)
    got = T.chunked_cross_entropy(params, cfg, ht, torch.from_numpy(labels).long(), chunk=8)
    got.backward()
    assert_close(got.detach().numpy(), np.asarray(want))
    jdp = lm_params_from_jax(_np_tree(jdp))
    jhead = [jdp["ln_f"]["scale"],
             jdp["embed"]["embedding"] if cfg.tie_embeddings else jdp["unembed"]["w"]]
    for g, p in zip([ht.grad] + [p.grad for p in head], [jdh] + jhead):
        assert_close(g.numpy(), np.asarray(p), tier="loose")


def test_chunked_cross_entropy_saves_no_full_logits():
    """Through `Model.loss`, forward and backward: no tensor autograd saves
    has B x S x V elements (the head's logits exist a chunk at a time), as
    the same loss through the full logits does."""
    cfg = get_config("qwen2-0.5b").reduced()
    B, S = 2, 64
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for p in api._leaves(params):
        p.requires_grad_(True)
    batch = lm_batch(cfg, B=B, S=S)
    chunked, full = _Saved(), _Saved()
    b = model._batch(batch)
    with chunked.hooks():
        h, _ = T.forward(params, cfg, b, return_hidden=True)
        loss = T.chunked_cross_entropy(params, cfg, h, b["labels"], chunk=16)
        loss.backward()
    with full.hooks():
        logits, _ = model.forward(params, batch)
        ref = api.softmax_cross_entropy(logits[:, :-1], b["labels"][:, 1:])
    assert_close(loss.detach().numpy(), ref.detach().numpy())
    assert full.max_numel >= B * (S - 1) * cfg.vocab
    assert chunked.max_numel < B * (S - 1) * cfg.vocab


# ---------------------------------------------------------------- flash


def _qkv(B, Tq, Tk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,T,H,KV,hd,qc,kc", [(2, 64, 4, 2, 16, 16, 16),
                                               (1, 128, 4, 4, 8, 32, 64),
                                               (2, 64, 6, 2, 16, 64, 16)])
def test_flash_forward_matches_full(causal, B, T, H, KV, hd, qc, kc):
    q, k, v = _qkv(B, T, T, H, KV, hd)
    got = attention.blockwise_attention(*map(_t, (q, k, v)), causal=causal, q_chunk=qc,
                                        kv_chunk=kc)
    full = attention.full_attention(*map(_t, (q, k, v)), causal=causal)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                     q_chunk=qc, kv_chunk=kc)
    assert_close(got.detach().numpy(), full.detach().numpy(), tol=2e-5)
    assert_close(got.detach().numpy(), np.asarray(want), tol=2e-5)


def _flash_grads(q, k, v, attend):
    ts = [_t(a, grad=True) for a in (q, k, v)]
    o = attend(*ts)
    (o * torch.cos(o)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_full(causal):
    """dq, dk, dv of the flash backward against autograd through
    `full_attention` (the reference test's 3e-4) and against the
    reference's custom VJP."""
    B, T, H, KV, hd = 2, 64, 4, 2, 16
    q, k, v = _qkv(B, T, T, H, KV, hd, seed=1)
    got = _flash_grads(q, k, v, lambda *a: attention.blockwise_attention(
        *a, causal=causal, q_chunk=16, kv_chunk=16))
    full = _flash_grads(q, k, v, lambda *a: attention.full_attention(*a, causal=causal))

    def jloss(q_, k_, v_):
        o = jattn.blockwise_attention(q_, k_, v_, causal=causal, q_chunk=16, kv_chunk=16)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for a, b, c in zip(got, full, want):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4)
        assert_close(a, np.asarray(c), tier="loose")


def test_flash_q_offset_decode_chunk():
    """A query block at an offset (the chunked-decode pattern): output and
    gradients against full attention at the same offset."""
    B, Tk, H, KV, hd = 1, 64, 4, 2, 16
    q, k, v = _qkv(B, 16, Tk, H, KV, hd, seed=2)
    off = 48
    flash = lambda *a: attention.blockwise_attention(  # noqa: E731
        *a, causal=True, q_chunk=8, kv_chunk=16, q_offset=off)
    full = lambda *a: attention.full_attention(*a, causal=True, q_offset=off)  # noqa: E731
    np.testing.assert_allclose(flash(*map(_t, (q, k, v))).numpy(),
                               full(*map(_t, (q, k, v))).numpy(), atol=2e-5, rtol=2e-5)
    for a, b in zip(_flash_grads(q, k, v, flash), _flash_grads(q, k, v, full)):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("qc,kc", [(64, 64), (16, 16), (8, 32)])
def test_flash_backward_saves_only_qkvo_lse(qc, kc):
    """Whatever the tile count, the flash function saves q, k, v, o and lse
    and nothing else: at most their bytes."""
    B, T, KV, G, hd = 2, 64, 2, 3, 16
    rng = np.random.default_rng(4)
    q = _t(rng.normal(size=(B, T, KV, G, hd)), grad=True)
    k, v = (_t(rng.normal(size=(B, T, KV, hd)), grad=True) for _ in range(2))
    saved = _Saved()
    with saved.hooks():
        o = flash_attention_grouped(q, k, v, True, qc, kc)
    limit = sum(a.numel() * a.element_size() for a in (q, k, v, o)) + B * KV * G * T * 4
    assert saved.nbytes <= limit, (saved.nbytes, limit)
    o.sum().backward()
    assert all(a.grad is not None for a in (q, k, v))
