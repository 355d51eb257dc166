"""RWKV6 (Finch) WKV recurrence: the chunked scan and its Hopper kernel.

Recurrence (per batch, head; K/V head dims):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Chunked form (chunk C, lw = cumsum log w within the chunk, lw_prev its
one-step shift with lw_prev_0 = 0):
    intra:  A[i,j] = sum_k r[i,k] k[j,k] exp(lw_prev[i,k] - lw[j,k])   (j < i)
            + diag(sum_k r[i,k] u[k] k[i,k])
    inter:  o += (r * exp(lw_prev)) @ S_chunk_start
    state:  S' = diag(exp(lw_C)) S + (k * exp(lw_C - lw))^T v

Every exponent is masked to j < i before the exponential, so no decay,
however strong, overflows.

* `wkv6_chunked` — the plain PyTorch version: the reference's chunked scan
  (``repro.kernels.wkv6.wkv6_chunked``) as a Python loop over chunks,
  differentiable.
* `launch_wkv6_kernel` — the wrapper of ``csrc/wkv6.cu`` (sm_90a, f32
  arithmetic): r, k and v float32 or bfloat16 (all three alike, read as
  they are and upcast on load, exactly), w and u float32.  It checks its
  inputs, allocates o, the final S and the kernel's scratch (S at every
  chunk's start, [B*H, T/C, K, V] float32, written by the sequential state
  pass and read by the chunk-parallel output pass), enqueues both passes
  on the current stream, raises on a launch error, and counts one launch
  per call (`kernel_stats()['wkv6']`), as the reference has one
  pallas_call per call.
* `wkv6_hopper` — the sequence path's scan: the kernel on CUDA tensors, as
  they come (no copy: the model's r, k, v are contiguous in its compute
  dtype, w and u float32), the plain version on CPU tensors (only there).
  Like the reference's Pallas kernel it has no gradient: off the CPU, an
  input that requires grad (with grad mode on) raises.
* `wkv6_hopper_grad` — the training route of the scan: on CUDA tensors its
  forward is the kernel (one counted launch, the inputs saved) and its
  backward re-runs `wkv6_chunked` on the saved inputs and returns its
  gradients, the jnp scan the reference's models differentiate; on CPU
  tensors it is `wkv6_chunked` with its own autograd.  Under
  ``torch.no_grad()`` it is the kernel's one launch, as `wkv6_hopper`.

The chunk length is C = min(chunk, T), and T must be a multiple of C: a
prompt is not padded, since padding would change the state.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load as _load

__all__ = ["wkv6_chunked", "launch_wkv6_kernel", "wkv6_hopper", "wkv6_hopper_grad",
           "kernel_stats", "reset_kernel_stats"]

# calls of the kernel since the last reset (ticked in `launch_wkv6_kernel`
# only, once per call: one call enqueues both passes)
_STATS = {"wkv6": 0}
# the kernel keeps one chunk of r, k, log w and v, the chunk's A and the
# state at the chunk's start in shared memory: K, V and C up to 64 fit (V a
# multiple of 4, for its float4 loads and stores along V)
_MAX_DIM = 64


def kernel_stats() -> dict:
    """{'wkv6': kernel calls (each both passes)} since the last reset."""
    return dict(_STATS)


def reset_kernel_stats() -> None:
    _STATS["wkv6"] = 0


def _chunk_len(T: int, chunk: int) -> int:
    C = min(chunk, T)
    if C < 1 or T % C:
        raise ValueError(f"T={T} is not a multiple of the chunk length C={C} "
                         f"(chunk={chunk}); the scan takes whole chunks and does "
                         "not pad")
    return C


def wkv6_chunked(r, k, v, w, u, chunk: int = 64, return_state: bool = False):
    """r, k, w [B,T,H,K]; v [B,T,H,V]; u [H,K] -> o [B,T,H,V] (float32 inside).

    With return_state, also returns the final S [B,H,K,V] (the prefill ->
    decode handoff)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    C = _chunk_len(T, chunk)
    n = T // C

    def to_bh(x, d):  # [B,T,H,d] -> [n, B*H, C, d]
        return x.float().permute(0, 2, 1, 3).reshape(B * H, n, C, d).transpose(0, 1)

    rs, ks, ws, vs = to_bh(r, K), to_bh(k, K), to_bh(w, K), to_bh(v, V)
    u_rows = u.float().repeat(B, 1)  # row b*H + h is u[h]
    idx = torch.arange(C, device=r.device)
    mask = (idx[:, None] > idx[None, :])[None, :, :, None]
    S = torch.zeros((B * H, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(n):
        rc, kc, vc, wc = rs[c], ks[c], vs[c], ws[c]
        lw = torch.log(wc.clamp(1e-12, 1.0)).cumsum(1)
        lw_prev = F.pad(lw[:, :-1], (0, 0, 1, 0))
        diff = lw_prev[:, :, None, :] - lw[:, None, :, :]
        E = torch.exp(torch.where(mask, diff, float("-inf")))
        A = (rc[:, :, None, :] * kc[:, None, :, :] * E).sum(-1)
        A_diag = (rc * u_rows[:, None, :] * kc).sum(-1)
        o = A @ vc + A_diag[..., None] * vc
        outs.append(o + (rc * torch.exp(lw_prev)) @ S)
        k_t = kc * torch.exp(lw[:, -1:, :] - lw)
        S = torch.exp(lw[:, -1, :])[..., None] * S + k_t.transpose(1, 2) @ vc
    o = torch.stack(outs).transpose(0, 1).reshape(B, H, T, V).permute(0, 2, 1, 3)
    if return_state:
        return o, S.reshape(B, H, K, V)
    return o


def _declare(lib) -> None:
    fn = lib.wkv6_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def launch_wkv6_kernel(r, k, v, w, u, chunk: int = 64):
    """Run the CUDA WKV6 kernel: r, k [B,T,H,K] and v [B,T,H,V] (all three
    float32, or all three bfloat16), w [B,T,H,K] and u [H,K] (float32), all
    contiguous (r, k, v and w 16-byte aligned) on one CUDA device ->
    (o [B,T,H,V], final S [B,H,K,V]), both float32.  The two passes share
    a scratch of S at every chunk's start, [B*H, T/C, K, V] float32,
    allocated here.  One call is one counted launch.  Raises on anything
    the kernel does not take and on a launch error; never falls back."""
    dev = r.device
    for t in (r, k, v, w, u):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"the wkv6 kernel needs every tensor on one CUDA "
                             f"device, got {t.device} beside {dev}")
        if not t.is_contiguous():
            raise ValueError("the wkv6 kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("the wkv6 kernel takes r, k, v and w 16-byte aligned "
                         "(it loads four elements at a time)")
    if r.dtype not in (torch.float32, torch.bfloat16) or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"the wkv6 kernel takes r, k and v all float32 or all "
                         f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"the wkv6 kernel takes w and u in float32, got {w.dtype} "
                         f"and {u.dtype}")
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"r and v must be [B,T,H,K] and [B,T,H,V], got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    B, T, H, K = r.shape
    V = v.shape[3]
    if (k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (B, T, H)
            or u.shape != (H, K)):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"w {tuple(w.shape)} and u {tuple(u.shape)} do not fit")
    C = _chunk_len(T, chunk)
    if K > _MAX_DIM or V > _MAX_DIM or C > _MAX_DIM or V % 4:
        raise ValueError(f"the wkv6 kernel takes K, V and the chunk up to {_MAX_DIM} "
                         f"and V a multiple of 4, got K={K}, V={V}, C={C}")
    o = torch.empty((B, T, H, V), device=dev, dtype=torch.float32)
    S = torch.empty((B, H, K, V), device=dev, dtype=torch.float32)
    if B * H == 0:
        return o, S
    S_start = torch.empty((B * H, T // C, K, V), device=dev, dtype=torch.float32)
    lib = _load("wkv6", _declare)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wkv6_forward(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                              u.data_ptr(), o.data_ptr(), S.data_ptr(), S_start.data_ptr(),
                              B, T, H, K, V, C, int(r.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, H={H}, K={K}, V={V}, C={C}, {r.dtype})")
    _STATS["wkv6"] += 1
    return o, S


def wkv6_hopper(r, k, v, w, u, chunk: int = 64, return_state: bool = False):
    """The WKV6 scan (same arguments and result as `wkv6_chunked`) on the
    Hopper kernel for CUDA tensors; CPU tensors run the plain version.

    CUDA tensors go to the kernel as they come, not copied: r, k, v all
    float32 or all bfloat16, w and u float32, all contiguous (as the model
    makes them); anything else raises.  The kernel route has no gradient,
    like the reference's Pallas kernel: with grad mode on, an input that
    requires grad raises rather than return a result cut off from the
    graph."""
    ins = (r, k, v, w, u)
    if all(a.device.type == "cpu" for a in ins):
        return wkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=return_state)
    if torch.is_grad_enabled() and any(a.requires_grad for a in ins):
        raise RuntimeError("the wkv6 kernel has no gradient: call it under "
                           "torch.no_grad() or on inputs that do not require grad")
    o, S = launch_wkv6_kernel(*ins, chunk=chunk)
    return (o, S) if return_state else o


def _plain_backward(fn, saved, needs, grads_out, **kw):
    """The gradients of ``fn(*saved, **kw)`` (a plain scan returning its
    output and final state) with respect to the saved inputs whose
    ``needs`` is true, against the output gradients ``grads_out`` (None for
    an output that takes none): the forward re-run on detached copies under
    grad mode, then ``torch.autograd.grad``."""
    ins = [a.detach().requires_grad_(n) for a, n in zip(saved, needs)]
    pairs = [g is not None for g in grads_out]
    if not any(pairs) or not any(needs):
        return [None] * len(ins)
    with torch.enable_grad():
        outs = fn(*ins, return_state=True, **kw)
        wrt = [a for a in ins if a.requires_grad]
        got = iter(torch.autograd.grad([o for o, p in zip(outs, pairs) if p], wrt,
                                       [g for g in grads_out if g is not None],
                                       allow_unused=True))
    return [next(got) if a.requires_grad else None for a in ins]


class _Wkv6Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return launch_wkv6_kernel(r, k, v, w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, do, dS):
        grads = _plain_backward(wkv6_chunked, ctx.saved_tensors, ctx.needs_input_grad[:5],
                               (do, dS), chunk=ctx.chunk)
        return (*grads, None)


def wkv6_hopper_grad(r, k, v, w, u, chunk: int = 64, return_state: bool = False):
    """The WKV6 scan (as `wkv6_chunked`) with a gradient: on CUDA tensors
    the kernel forward (the same inputs `wkv6_hopper` takes, as they come)
    and the plain chunked scan's gradients in the backward; on CPU tensors
    the plain version.  A kernel that fails to build or launch raises."""
    ins = (r, k, v, w, u)
    if all(a.device.type == "cpu" for a in ins):
        return wkv6_chunked(*ins, chunk=chunk, return_state=return_state)
    o, S = _Wkv6Train.apply(*ins, chunk)
    return (o, S) if return_state else o
