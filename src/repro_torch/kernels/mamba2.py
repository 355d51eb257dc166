"""Mamba-2 SSD (state-space duality) scan: the chunked scan and its Hopper
kernel.

Per head (headdim P, state N, scalar A < 0):
    h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T        h in R^{P x N}
    y_t = h_t C_t + D x_t

Chunked (chunk C, la = cumsum(A dt) within the chunk, all exponents <= 0):
    intra:  M[i,j] = exp(la_i - la_j) (C_i . B_j) dt_j   (j <= i);  Y = M X
    inter:  y_i += exp(la_i) (h_0 C_i)
    state:  h' = exp(la_C) h_0 + sum_j exp(la_C - la_j) dt_j x_j B_j^T

The heads of a group share B and C (G groups, H/G heads each).  la is a
sequential float32 sum over the chunk's steps, in the plain version and in
the kernel alike: at full width A dt reaches -31.99 a step, so la reaches
several hundred within a chunk and la_i - la_j cancels; two summation
orders would round it apart.

* `mamba2_ssd_chunked` — the plain PyTorch version: the reference's chunked
  scan (``repro.kernels.mamba2.mamba2_ssd_chunked``) as a Python loop over
  chunks, differentiable.
* `launch_mamba2_kernel` — the wrapper of ``csrc/mamba2_ssd.cu`` (sm_90a,
  f32 arithmetic; x, B and C in float32 or bfloat16, read as they are): it
  checks its inputs, allocates y, the final h and the scratch h_start
  [Bt*H, T/C, N, P] (the state at every chunk's start, transposed), and
  enqueues the kernel's two passes on the current stream: a state pass
  sequential over the chunks (grid (Bt*H, P/32), 128 threads, the next
  chunk copied ahead by cp.async), which writes h_start and the final h
  and does no C x C work, then an output pass with one block per (b, h,
  tile of 64 P columns, chunk) (256 threads, 68.1 KB of shared memory),
  which forms y from its chunk and h_start alone.  It raises on a launch error and counts one launch per
  call, both passes together (`kernel_stats()['mamba2_ssd']`).
* `mamba2_ssd_hopper` — the sequence path's scan: the kernel on CUDA
  tensors, the plain version on CPU tensors (only there).  Like the
  reference's Pallas kernel it has no gradient: off the CPU, an input that
  requires grad (with grad mode on) raises.
* `mamba2_ssd_hopper_grad` — the training route of the scan: on CUDA
  tensors its forward is the kernel (one counted launch, the inputs saved)
  and its backward re-runs `mamba2_ssd_chunked` on the saved inputs and
  returns its gradients, the jnp scan the reference's models
  differentiate; on CPU tensors it is `mamba2_ssd_chunked` with its own
  autograd.  Under ``torch.no_grad()`` it is the kernel's one launch, as
  `mamba2_ssd_hopper`.

The chunk length is C = min(chunk, T), and T must be a multiple of C: a
prompt is not padded, since padding would change the state.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load as _load
from .wkv6 import _chunk_len, _plain_backward

__all__ = ["mamba2_ssd_chunked", "launch_mamba2_kernel", "mamba2_ssd_hopper",
           "mamba2_ssd_hopper_grad", "kernel_stats", "reset_kernel_stats"]

# launches of the kernel since the last reset (ticked in
# `launch_mamba2_kernel` only, once per launch)
_STATS = {"mamba2_ssd": 0}


def kernel_stats() -> dict:
    """{'mamba2_ssd': launches} since the last reset."""
    return dict(_STATS)


def reset_kernel_stats() -> None:
    _STATS["mamba2_ssd"] = 0


def _cumsum_seq(a: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis, one float32 add per step in
    order (the kernel's order; ``torch.cumsum`` on the card sums as a
    tree)."""
    cols = [a[..., 0]]
    for i in range(1, a.shape[-1]):
        cols.append(cols[-1] + a[..., i])
    return torch.stack(cols, dim=-1)


def mamba2_ssd_chunked(x, dt, A, B, C, D, chunk: int = 64, return_state: bool = False):
    """x [Bt,T,H,P]; dt [Bt,T,H]; A [H]; B, C [Bt,T,G,N]; D [H] -> y [Bt,T,H,P]
    float32 (float32 inside).

    With return_state, also returns the final h [Bt,H,P,N] (the prefill ->
    decode handoff)."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hpg = H // G
    Ck = _chunk_len(T, chunk)
    n = T // Ck
    R = Bt * H

    def to_r(a, d):  # [Bt,T,H,d] -> [n, R, Ck, d]
        return a.float().permute(0, 2, 1, 3).reshape(R, n, Ck, d).transpose(0, 1)

    xs = to_r(x, P)
    Bs = to_r(B.repeat_interleave(hpg, dim=2), N)
    Cs = to_r(C.repeat_interleave(hpg, dim=2), N)
    dts = dt.float().permute(0, 2, 1).reshape(R, n, Ck).transpose(0, 1)  # [n,R,Ck]
    A_r = A.float().repeat(Bt)  # row b*H + h is A[h]
    las = _cumsum_seq(A_r[None, :, None] * dts)  # [n,R,Ck], <= 0 and decreasing
    idx = torch.arange(Ck, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None]
    h = torch.zeros((R, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(n):
        xc, Bc, Cc, dtc, la = xs[c], Bs[c], Cs[c], dts[c], las[c]
        diff = la[:, :, None] - la[:, None, :]  # [R,i,j]
        Mexp = torch.exp(torch.where(mask, diff, float("-inf")))
        M = Mexp * (Cc @ Bc.transpose(1, 2)) * dtc[:, None, :]
        y = M @ xc
        ys.append(y + torch.exp(la)[..., None] * (Cc @ h.transpose(1, 2)))
        w = torch.exp(la[:, -1:] - la)[..., None] * dtc[..., None]  # [R,Ck,1]
        h = torch.exp(la[:, -1])[:, None, None] * h + (xc * w).transpose(1, 2) @ Bc
    y = torch.stack(ys).transpose(0, 1).reshape(Bt, H, T, P).permute(0, 2, 1, 3)
    y = y + D.float()[None, None, :, None] * x.float()
    if return_state:
        return y, h.reshape(Bt, H, P, N)
    return y


def _declare(lib) -> None:
    fn = lib.mamba2_ssd_forward
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _token_stride(t: torch.Tensor):
    """The token stride of t [Bt,T,a,b] if the kernel can read it as it is
    (each token's [a,b] dense, the tokens of all sequences evenly spaced,
    as in a view split from a wider row), else None."""
    if t.dim() != 4:
        return None
    Bt, T, a, b = t.shape
    if (b > 1 and t.stride(3) != 1) or (a > 1 and t.stride(2) != b):
        return None
    s = t.stride(1) if T > 1 else t.stride(0)
    return s if Bt == 1 or t.stride(0) == T * s else None


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    return t if _token_stride(t) is not None else t.contiguous()


def launch_mamba2_kernel(x, dt, A, B, C, D, chunk: int = 64):
    """Run the CUDA SSD kernel: x [Bt,T,H,P], B, C [Bt,T,G,N] (all three
    float32, or all three bfloat16; each a token row, dense within the
    token, that may be a view into a wider row), dt [Bt,T,H], A [H], D [H]
    (float32, contiguous), on one CUDA device -> (y [Bt,T,H,P] with D x
    added, final h [Bt,H,P,N]), both float32.  One call enqueues both
    passes and counts one launch.  Raises on anything the kernel does not
    take (the C entry point refuses N or a chunk above 64, and more than
    65535 chunks) and on a launch error; never falls back."""
    dev = x.device
    for t in (x, dt, A, B, C, D):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"the mamba2_ssd kernel needs every tensor on one CUDA "
                             f"device, got {t.device} beside {dev}")
    if not all(t.is_contiguous() for t in (dt, A, D)):
        raise ValueError("the mamba2_ssd kernel takes contiguous dt, A and D")
    if x.dtype not in (torch.float32, torch.bfloat16) or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"the mamba2_ssd kernel takes x, B and C all float32 or all "
                         f"bfloat16, got {x.dtype}, {B.dtype}, {C.dtype}")
    for t in (dt, A, D):
        if t.dtype != torch.float32:
            raise ValueError(f"the mamba2_ssd kernel takes dt, A and D in float32, "
                             f"got {t.dtype}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x and B must be [Bt,T,H,P] and [Bt,T,G,N], got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (B.shape[:2] != (Bt, T) or C.shape != B.shape or dt.shape != (Bt, T, H)
            or A.shape != (H,) or D.shape != (H,) or G < 1 or H % G):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)} and D {tuple(D.shape)} "
                         "do not fit")
    Ck = _chunk_len(T, chunk)
    strides = [_token_stride(t) for t in (x, B, C)]
    if None in strides:
        raise ValueError("the mamba2_ssd kernel takes x, B and C as token rows: dense "
                         "within each token, the tokens evenly spaced")
    y = torch.empty((Bt, T, H, P), device=dev, dtype=torch.float32)
    h = torch.empty((Bt, H, P, N), device=dev, dtype=torch.float32)
    if Bt * H * P == 0:
        return y, h
    # the state at every chunk's start, [n][p]: written by the state pass,
    # read by the output pass
    h_start = torch.empty((Bt * H, T // Ck, N, P), device=dev, dtype=torch.float32)
    lib = _load("mamba2_ssd", _declare)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mamba2_ssd_forward(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                    B.data_ptr(), C.data_ptr(), D.data_ptr(),
                                    y.data_ptr(), h.data_ptr(), h_start.data_ptr(),
                                    Bt, T, H, P, G, N, Ck,
                                    *strides, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error {rc} "
                           f"(Bt={Bt}, T={T}, H={H}, P={P}, G={G}, N={N}, C={Ck})")
    _STATS["mamba2_ssd"] += 1
    return y, h


def mamba2_ssd_hopper(x, dt, A, B, C, D, chunk: int = 64, return_state: bool = False):
    """The SSD scan (same arguments and result as `mamba2_ssd_chunked`) on
    the Hopper kernel for CUDA tensors; CPU tensors run the plain version.

    The kernel reads bfloat16 x, B and C as they are (upcast on load,
    exactly), and reads views split from a wider token row in place (the
    model's x, B and C are such views of one conv output): they are not
    copied.  Other dtypes, or x, B and C of differing dtypes, go to it in
    float32.  It has no gradient, like the reference's Pallas kernel: with
    grad mode on, an input that requires grad raises rather than return a
    result cut off from the graph."""
    ins = (x, dt, A, B, C, D)
    if all(a.device.type == "cpu" for a in ins):
        return mamba2_ssd_chunked(*ins, chunk=chunk, return_state=return_state)
    if torch.is_grad_enabled() and any(a.requires_grad for a in ins):
        raise RuntimeError("the mamba2_ssd kernel has no gradient: call it under "
                           "torch.no_grad() or on inputs that do not require grad")
    y, h = _launch(*ins, chunk=chunk)
    return (y, h) if return_state else y


def _launch(x, dt, A, B, C, D, chunk: int):
    """The kernel on the model's inputs: bfloat16 x, B and C as they are
    (all three alike), else float32; token-row views read in place."""
    io = x.dtype if x.dtype == B.dtype == C.dtype == torch.bfloat16 else torch.float32
    return launch_mamba2_kernel(_as_rows(x.to(io)), dt.float().contiguous(),
                                A.float().contiguous(), _as_rows(B.to(io)),
                                _as_rows(C.to(io)), D.float().contiguous(), chunk=chunk)


class _SsdTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return _launch(x, dt, A, B, C, D, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        grads = _plain_backward(mamba2_ssd_chunked, ctx.saved_tensors,
                               ctx.needs_input_grad[:6], (dy, dh), chunk=ctx.chunk)
        return (*grads, None)


def mamba2_ssd_hopper_grad(x, dt, A, B, C, D, chunk: int = 64, return_state: bool = False):
    """The SSD scan (as `mamba2_ssd_chunked`) with a gradient: on CUDA
    tensors the kernel forward (the inputs as `mamba2_ssd_hopper` takes
    them) and the plain chunked scan's gradients in the backward; on CPU
    tensors the plain version.  A kernel that fails to build or launch
    raises."""
    ins = (x, dt, A, B, C, D)
    if all(a.device.type == "cpu" for a in ins):
        return mamba2_ssd_chunked(*ins, chunk=chunk, return_state=return_state)
    y, h = _SsdTrain.apply(*ins, chunk)
    return (y, h) if return_state else y
