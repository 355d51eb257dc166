"""The port's WKV6 scan (plain version and kernel wrapper) against the JAX
reference: `wkv6_chunked`, `wkv6_pallas` in interpret mode and the naive
recurrence `wkv6_ref`, on the shapes of the reference's kernel tests, at
the f32 identity tier (3e-4 scale-relative).  The kernel's two-pass split
(S at every chunk's start first, then every chunk's output on its own) is
written out in torch here and held to the reference the same way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6_chunked as jwkv6_chunked
from repro.kernels.wkv6 import wkv6_pallas
from repro.testing import assert_close
from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.kernels.wkv6 import kernel_stats, wkv6_chunked, wkv6_hopper


def _inputs(B, T, H, K, V, seed, decay="uniform"):
    """r, k, v, w, u as tests/test_kernels.py draws them (numpy, f32)."""
    rng = np.random.default_rng(seed)
    scale = 1.0 if decay == "extreme" else 0.5
    r = rng.normal(size=(B, T, H, K)) * scale
    k = rng.normal(size=(B, T, H, K)) * scale
    v = rng.normal(size=(B, T, H, V))
    if decay == "uniform":
        w = rng.uniform(0.2, 0.999, size=(B, T, H, K))
    else:
        w = np.full((B, T, H, K), 0.999 if decay == "near_one" else 1e-6)
    u = np.zeros((H, K)) if decay == "extreme" else rng.normal(size=(H, K)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("T,chunk", [(32, 8), (64, 16), (48, 16)])
@pytest.mark.parametrize("K", [8, 16])
def test_wkv6_chunked_matches_reference(T, chunk, K):
    arrs = _inputs(2, T, 3, K, K, seed=10)
    o, S = wkv6_chunked(*_torch(arrs), chunk=chunk, return_state=True)
    jo, jS = jwkv6_chunked(*_jax(arrs), chunk=chunk, return_state=True)
    assert_close(o.numpy(), np.asarray(jo))
    assert_close(S.numpy(), np.asarray(jS))
    assert_close(o.numpy(), np.asarray(jref.wkv6_ref(*_jax(arrs))))


@pytest.mark.parametrize("B,T,H,K,chunk", [(2, 32, 2, 8, 8), (1, 64, 2, 16, 64)])
def test_wkv6_chunked_matches_pallas_interpret(B, T, H, K, chunk):
    arrs = _inputs(B, T, H, K, K, seed=11)
    got = wkv6_chunked(*_torch(arrs), chunk=chunk)
    want = wkv6_pallas(*_jax(arrs), chunk=chunk, interpret=True)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("decay,K", [("extreme", 8), ("extreme", 64), ("near_one", 16)])
def test_wkv6_decay_edges_match_reference(decay, K):
    """w = 1e-6 (near-total forgetting) stays finite; w = 0.999 carries the
    state across chunks."""
    T = 64 if decay == "extreme" else 128
    arrs = _inputs(1, T, 2, K, K, seed=12, decay=decay)
    o, S = wkv6_chunked(*_torch(arrs), chunk=64 if decay == "extreme" else 32,
                        return_state=True)
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    jo, jS = jwkv6_chunked(*_jax(arrs), chunk=64 if decay == "extreme" else 32,
                           return_state=True)
    assert_close(o.numpy(), np.asarray(jo))
    assert_close(S.numpy(), np.asarray(jS))
    assert_close(o.numpy(), np.asarray(jref.wkv6_ref(*_jax(arrs))))


def test_wkv6_short_prompt_takes_one_chunk():
    """T < chunk: C = T, one chunk, as the reference."""
    arrs = _inputs(2, 40, 3, 16, 16, seed=13)
    o, S = wkv6_chunked(*_torch(arrs), chunk=64, return_state=True)
    jo, jS = jwkv6_chunked(*_jax(arrs), chunk=64, return_state=True)
    assert_close(o.numpy(), np.asarray(jo))
    assert_close(S.numpy(), np.asarray(jS))


def test_wkv6_ref_matches_reference_oracle():
    arrs = _inputs(2, 24, 3, 8, 12, seed=14)
    assert_close(wkv6_ref(*_torch(arrs)).numpy(), np.asarray(jref.wkv6_ref(*_jax(arrs))))


def test_wkv6_plain_gradient_matches_reference():
    """The plain version stays differentiable: its gradient equals jax.grad
    of the reference scan."""
    arrs = _inputs(1, 32, 2, 8, 8, seed=15)
    cot = np.random.default_rng(16).normal(size=(1, 32, 2, 8)).astype(np.float32)
    ts = [t.requires_grad_(True) for t in _torch(arrs)]
    (wkv6_chunked(*ts, chunk=16) * torch.from_numpy(cot)).sum().backward()

    def loss(*a):
        return jnp.sum(jwkv6_chunked(*a, chunk=16) * cot)

    jg = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*_jax(arrs))
    for t, g in zip(ts, jg):
        assert_close(t.grad.numpy(), np.asarray(g), tier="loose")


def test_wkv6_hopper_runs_plain_version_for_cpu_tensors():
    arrs = _inputs(2, 32, 3, 8, 8, seed=17)
    before = kernel_stats()["wkv6"]
    o, S = wkv6_hopper(*_torch(arrs), chunk=8, return_state=True)
    want_o, want_S = wkv6_chunked(*_torch(arrs), chunk=8, return_state=True)
    assert torch.equal(o, want_o) and torch.equal(S, want_S)
    assert torch.equal(ops.wkv6(*_torch(arrs), chunk=8), want_o)
    assert kernel_stats()["wkv6"] == before  # no kernel launch on the CPU


@pytest.mark.parametrize("fn", [wkv6_hopper, wkv6_chunked])
def test_wkv6_rejects_ragged_chunks(fn):
    """T = 100 is not a multiple of C = 64: raise, as the reference does;
    the prompt is not padded."""
    arrs = _torch(_inputs(1, 100, 2, 8, 8, seed=18))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        fn(*arrs, chunk=64)


def test_wkv6_hopper_off_cpu_is_the_kernel():
    arrs = [t.to("meta") for t in _torch(_inputs(1, 32, 2, 8, 8, seed=19))]
    with pytest.raises(ValueError, match="CUDA device"):
        wkv6_hopper(*arrs, chunk=8)
    arrs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        wkv6_hopper(*arrs, chunk=8)


def _two_pass(r, k, v, w, u, chunk):
    """The CUDA kernel's split of the chunked scan, in torch: the state pass
    (sequential over chunks, no C x C work) forms S at every chunk's start
    and the final S; the output pass then forms every chunk's output from
    its own inputs and its S_start alone, all chunks at once.  Base-2 logs
    and exponentials, and A's exponentials split as the kernel splits
    them."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    C = min(chunk, T)
    n = T // C

    def to_bh(x, d):  # [B,T,H,d] -> [B*H, n, C, d]
        return x.float().permute(0, 2, 1, 3).reshape(B * H, n, C, d)

    rs, ks, vs = to_bh(r, K), to_bh(k, K), to_bh(v, V)
    lw = torch.log2(to_bh(w, K).clamp(1e-12, 1.0)).cumsum(2)
    # state pass
    S = torch.zeros((B * H, K, V))
    starts = []
    for c in range(n):
        starts.append(S)
        kt = ks[:, c] * torch.exp2(lw[:, c, -1:] - lw[:, c])
        S = torch.exp2(lw[:, c, -1])[..., None] * S + kt.transpose(1, 2) @ vs[:, c]
    S_start = torch.stack(starts, 1)  # [B*H, n, K, V]
    # output pass: no chunk reads another's.  Below the diagonal's 4 x 4
    # tiles the exponential is factored through the pivot L = lw of the
    # tile's last column (both factors <= 1); on them it is masked per entry
    lw_prev = torch.nn.functional.pad(lw[:, :, :-1], (0, 0, 1, 0))
    idx = torch.arange(C)
    mask = (idx[:, None] > idx[None, :])[..., None]
    diff = lw_prev[:, :, :, None, :] - lw[:, :, None, :, :]
    E_own = torch.exp2(torch.where(mask, diff, float("-inf")))
    L = lw[:, :, (4 * (idx // 4) + 3).clamp(max=C - 1)]  # [B*H, n, C (j), K]
    E_piv = (torch.exp2((lw_prev[:, :, :, None, :] - L[:, :, None]).clamp(max=0.0))
             * torch.exp2((L - lw).clamp(max=0.0))[:, :, None])
    below = (idx[:, None] // 4 > idx[None, :] // 4)[..., None]
    E = torch.where(below, E_piv, E_own)
    A = (rs[:, :, :, None, :] * ks[:, :, None, :, :] * E).sum(-1)
    A_diag = (rs * u.float().repeat(B, 1)[:, None, None, :] * ks).sum(-1)
    o = A @ vs + A_diag[..., None] * vs + (rs * torch.exp2(lw_prev)) @ S_start
    o = o.reshape(B, H, T, V).permute(0, 2, 1, 3)
    return o, S.reshape(B, H, K, V)


@pytest.mark.parametrize("K,T,chunk,decay", [(8, 32, 8, "uniform"), (8, 64, 16, "uniform"),
                                             (8, 48, 16, "uniform"), (16, 32, 8, "uniform"),
                                             (16, 64, 16, "uniform"), (16, 48, 16, "uniform"),
                                             (16, 128, 32, "near_one"),
                                             (8, 64, 64, "extreme"), (64, 128, 64, "extreme")])
def test_wkv6_two_pass_split_matches_reference(K, T, chunk, decay):
    """States at chunk starts first, then each chunk's output on its own:
    the same sums as the chunked scan in another order (f32 identity tier),
    finite at w = 1e-6."""
    arrs = _inputs(2, T, 3, K, K, seed=20 + K + T, decay=decay)
    o, S = _two_pass(*_torch(arrs), chunk=chunk)
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    jo, jS = jwkv6_chunked(*_jax(arrs), chunk=chunk, return_state=True)
    assert_close(o.numpy(), np.asarray(jo))
    assert_close(S.numpy(), np.asarray(jS))


def test_wkv6_hopper_bf16_rkv_on_cpu_is_the_f32_upcast():
    """bf16 r, k, v (as the model feeds them; w, u float32) give exactly what
    their float32 upcasts give: the upcast is exact."""
    r, k, v, w, u = _torch(_inputs(2, 64, 3, 16, 16, seed=21))
    rb, kb, vb = (a.to(torch.bfloat16) for a in (r, k, v))
    o, S = wkv6_hopper(rb, kb, vb, w, u, chunk=16, return_state=True)
    want_o, want_S = wkv6_chunked(rb.float(), kb.float(), vb.float(), w, u, chunk=16,
                                  return_state=True)
    assert o.dtype == S.dtype == torch.float32
    assert torch.equal(o, want_o) and torch.equal(S, want_S)
