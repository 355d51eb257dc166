"""The Gaunt collocation products — the n-way chain and the pairwise
product — each with its plain version and its Hopper kernel wrapper.

Pairwise (the reference's ``gaunt_fused_pallas``):

    out = ((x1 @ T1) * (x2 @ T2)) @ P

on the distinct sphere points of the product grid
(`core.constants.pair_matrices`):

* `pair_plain` — the kernel's plain PyTorch version (matmuls);
  `gaunt_fused_torch` runs it behind the ``fused_torch`` pairwise backend.
* `launch_pair_kernel` — the wrapper of ``csrc/gaunt_pair.cu`` (sm_90a,
  f32 storage, both products on tensor cores in 3xTF32): takes the folded
  matrices split into TF32 hi and lo in the kernel's fragment order
  (`pair_kernel_constants`), checks its inputs, launches on the current
  stream, raises on a launch error, and counts launches
  (`kernel_stats()['gaunt_pair']`).
* `gaunt_fused_hopper` — the ``fused_hopper`` pairwise backend: the kernel
  on CUDA tensors, the plain version on CPU tensors (only there).  Like the
  reference's Pallas kernel it has no gradient: off the CPU, an input that
  requires grad (with grad mode on) raises.

Chain:

    out = ((x_1 @ T_1) * (x_2 @ T_2) * ... * (x_n @ T_n)  [* gs + gb]) @ P

T_i samples operand i on the alias-free product grid and P projects the
product samples back; with 'sh' entries the grid is folded to its distinct
sphere points (`core.constants.chain_matrices_folded`); the optional
gate (gs, gb) is the affine pointwise stage of the models' gate.  Three
realizations, one function:

* `chain_plain` — the kernel's plain PyTorch version (matmuls).  The
  `fused_torch` chain backend (`gaunt_chain_fused_torch`) runs it with
  autograd through torch ops; tests and the on-card comparison use it.
* `launch_chain_kernel` — the wrapper of the hand-written CUDA kernel
  (``csrc/gaunt_chain.cu``, sm_90a, f32).  It checks its inputs, launches on
  the current stream, raises on a launch error, and counts launches
  (`kernel_stats`).
* `gaunt_chain_fused_hopper` — the `fused_hopper` chain backend: an
  autograd Function whose forward runs the kernel on CUDA tensors (and the
  plain version on CPU tensors — only there) and whose backward is the
  reference's collocation VJP as differentiable torch ops, so a double
  backward works too.

Storage is float32 (float64 on the plain path); bfloat16 storage is not
ported yet and raises NotImplementedError.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import constants as _const
from .build import load as _load

__all__ = [
    "gaunt_fused_matrices",
    "pair_plain",
    "pair_kernel_constants",
    "launch_pair_kernel",
    "gaunt_fused_torch",
    "gaunt_fused_hopper",
    "chain_plain",
    "launch_chain_kernel",
    "gaunt_chain_fused_torch",
    "gaunt_chain_fused_hopper",
    "kernel_stats",
    "reset_kernel_stats",
]

# launches of each CUDA kernel since the last reset (ticked in
# `launch_chain_kernel` / `launch_pair_kernel` only, once per kernel launch)
_STATS = {"gaunt_chain": 0, "gaunt_pair": 0}


def kernel_stats() -> dict:
    """{'gaunt_chain': launches, 'gaunt_pair': launches} since the last reset."""
    return dict(_STATS)


def reset_kernel_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


# --------------------------------------------------------------------------
# pairwise: matrices, plain version, kernel wrapper, entry points
# --------------------------------------------------------------------------


def gaunt_fused_matrices(L1: int, L2: int, Lout: int, pad_lanes: bool = True,
                         dtype: str = "float32"):
    """Numpy (T1 [d1,G], T2 [d2,G], P [G,dout]) on the full torus grid, as
    the reference builds them (`core.constants.fused_matrices`).  The
    port's routes use the folded `core.constants.pair_matrices`."""
    return _const.fused_matrices(L1, L2, Lout, pad_lanes, dtype=dtype)


def pair_plain(x1, x2, T1, T2, P) -> torch.Tensor:
    """The pairwise collocation product in torch ops: rows [B, d1], [B, d2]
    -> [B, dout]."""
    return ((x1 @ T1) * (x2 @ T2)) @ P


def _declare_pair(lib) -> None:
    fn = lib.gaunt_pair_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gaunt_pair_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.gaunt_pair_smem_bytes.restype = ctypes.c_size_t


def pair_kernel_constants(L1: int, L2: int, Lout: int, device):
    """The pair kernel's constants on ``device``: (F1, F2, FP, dout), the
    folded matrices split into TF32 hi and lo, zero-padded and in the
    kernel's fragment order (`core.constants.pair_fragments`), built once
    per shape and cached per device."""
    F1, F2, FP = (_const.to_torch(a, device) for a in _const.pair_fragments(L1, L2, Lout))
    return F1, F2, FP, (Lout + 1) ** 2


def launch_pair_kernel(x1, x2, F1, F2, FP, dout: int) -> torch.Tensor:
    """Run the CUDA pairwise kernel: rows x1 [B, d1], x2 [B, d2] with the
    fragments F1 [NS, ceil(d1/8), 32, 4], F2 [NS, ceil(d2/8), 32, 4],
    FP [NS, ceil(dout/8), 32, 4] of `pair_kernel_constants` (f32,
    contiguous, on one CUDA device; NS a multiple of 4) -> [B, dout] f32.
    Raises on anything the kernel does not take and on a launch error;
    never falls back."""
    dev = x1.device
    for t in (x1, x2, F1, F2, FP):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"the pair kernel needs every tensor on one CUDA "
                             f"device, got {t.device} beside {dev}")
        if t.dtype != torch.float32:
            raise NotImplementedError(f"the pair kernel takes float32 storage, "
                                      f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the pair kernel takes contiguous tensors")
    if x1.dim() != 2 or x2.dim() != 2:
        raise ValueError("the pair kernel takes rows [B, d]")
    B, d1 = x1.shape
    d2 = x2.shape[1]
    NS = F1.shape[0]
    want = ((NS, -(-d1 // 8), 32, 4), (NS, -(-d2 // 8), 32, 4), (NS, -(-dout // 8), 32, 4))
    if (x2.shape[0] != B or NS % 4 or dout <= 0
            or (tuple(F1.shape), tuple(F2.shape), tuple(FP.shape)) != want):
        raise ValueError(f"operands {tuple(x1.shape)}, {tuple(x2.shape)} and fragments "
                         f"{tuple(F1.shape)}, {tuple(F2.shape)}, {tuple(FP.shape)} "
                         f"do not fit dout={dout}")
    lib = _load("gaunt_pair", _declare_pair)
    if lib.gaunt_pair_smem_bytes(d1, d2, dout) == 0:
        raise ValueError(f"the pair kernel does not take d1={d1}, d2={d2}, "
                         f"dout={dout} (up to d = 136 fits, any dout)")
    out = torch.empty((B, dout), device=dev, dtype=torch.float32)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gaunt_pair_forward(x1.data_ptr(), x2.data_ptr(), F1.data_ptr(),
                                    F2.data_ptr(), FP.data_ptr(), out.data_ptr(),
                                    B, d1, d2, dout, NS, stream)
    if rc != 0:
        raise RuntimeError(f"gaunt_pair kernel launch failed: CUDA error {rc} "
                           f"(d1={d1}, d2={d2}, NS={NS}, dout={dout}, B={B})")
    _STATS["gaunt_pair"] += 1
    return out


def _pair_rows(x1, x2):
    """Rows [B, d] in f32 (the kernel's storage; leading dims broadcast)."""
    if x1.device != x2.device:
        raise ValueError(f"operands on {x1.device} and {x2.device}")
    lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
    B = int(np.prod(lead)) if lead else 1
    rows = [a.to(torch.float32).expand(*lead, a.shape[-1]).reshape(B, a.shape[-1])
            for a in (x1, x2)]
    return rows, lead


def _pair_matrices(L1: int, L2: int, Lout: int, device):
    return tuple(_const.to_torch(a, device) for a in _const.pair_matrices(L1, L2, Lout))


def gaunt_fused_torch(x1, x2, L1: int, L2: int, Lout: int | None = None) -> torch.Tensor:
    """The pairwise collocation product as plain torch ops (the twin of the
    reference's ``fused_xla`` route): x1 [..., (L1+1)^2], x2 [...,
    (L2+1)^2] -> [..., (Lout+1)^2] f32, differentiable."""
    Lout = L1 + L2 if Lout is None else int(Lout)
    (a1, a2), lead = _pair_rows(x1, x2)
    out = pair_plain(a1, a2, *_pair_matrices(L1, L2, Lout, a1.device))
    return out.reshape(*lead, out.shape[-1])


def gaunt_fused_hopper(x1, x2, L1: int, L2: int, Lout: int | None = None) -> torch.Tensor:
    """The pairwise collocation product on the Hopper kernel (same arguments
    as `gaunt_fused_torch`; Lout defaults to L1 + L2).

    CUDA operands launch the kernel; CPU operands run the plain version.
    The kernel route has no gradient, like the reference's Pallas kernel:
    with grad mode on, a CUDA input that requires grad raises rather than
    return a result cut off from the graph."""
    kernel = x1.device.type != "cpu" or x2.device.type != "cpu"
    if kernel and torch.is_grad_enabled() and (x1.requires_grad or x2.requires_grad):
        raise RuntimeError("the gaunt_pair kernel has no gradient: call it under "
                           "torch.no_grad() or on inputs that do not require "
                           "grad, or plan a differentiable backend")
    Lout = L1 + L2 if Lout is None else int(Lout)
    (a1, a2), lead = _pair_rows(x1, x2)
    if kernel:
        out = launch_pair_kernel(a1.contiguous(), a2.contiguous(),
                                 *pair_kernel_constants(L1, L2, Lout, a1.device))
    else:
        out = pair_plain(a1, a2, *_pair_matrices(L1, L2, Lout, a1.device))
    return out.reshape(*lead, out.shape[-1])


# --------------------------------------------------------------------------
# chain: the plain version and the kernel wrapper (row layout [B, d])
# --------------------------------------------------------------------------


def chain_plain(flat, Ts, P, gs=None, gb=None) -> torch.Tensor:
    """The collocation product in torch ops: rows [B, d_i] -> [B, dout]."""
    v = flat[0] @ Ts[0]
    for a, T in zip(flat[1:], Ts[1:]):
        v = v * (a @ T)
    if gs is not None:
        v = v * gs + gb
    return v @ P


def _declare_chain(lib) -> None:
    fn = lib.gaunt_chain_forward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def launch_chain_kernel(flat, Ts, P, gs=None, gb=None) -> torch.Tensor:
    """Run the CUDA chain kernel: rows [B, d_i] (f32, contiguous, on one CUDA
    device) -> [B, dout].  Raises on anything the kernel does not take and
    on a launch error; never falls back."""
    n = len(flat)
    if not 2 <= n <= 4 or len(Ts) != n:
        raise ValueError(f"the chain kernel takes 2..4 operands with one T each, "
                         f"got {n} operands and {len(Ts)} matrices")
    dev = flat[0].device
    tensors = [*flat, *Ts, P] + ([gs, gb] if gs is not None else [])
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"the chain kernel needs every tensor on one CUDA "
                             f"device, got {t.device} beside {dev}")
        if t.dtype != torch.float32:
            raise NotImplementedError(f"the chain kernel takes float32 storage, "
                                      f"got {t.dtype}")
        if not t.is_contiguous() or t.dim() != 2:
            raise ValueError("the chain kernel takes contiguous 2-D tensors")
    B = flat[0].shape[0]
    G, dout = P.shape
    for a, T in zip(flat, Ts):
        if a.shape[0] != B or T.shape != (a.shape[1], G):
            raise ValueError(f"operand {tuple(a.shape)} / matrix {tuple(T.shape)} "
                             f"do not fit B={B}, G={G}")
    if gs is not None and (gs.shape != (B, 1) or gb.shape != (B, 1)):
        raise ValueError("gate scalars must be [B, 1]")
    out = torch.empty((B, dout), device=dev, dtype=torch.float32)
    if B == 0:
        return out
    ptrs = [a.data_ptr() for a in flat] + [0] * (4 - n)
    tptrs = [T.data_ptr() for T in Ts] + [0] * (4 - n)
    dims = [a.shape[1] for a in flat] + [0] * (4 - n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _load("gaunt_chain", _declare_chain).gaunt_chain_forward(
            *ptrs, *tptrs, *dims, n, P.data_ptr(),
            gs.data_ptr() if gs is not None else None,
            gb.data_ptr() if gb is not None else None,
            out.data_ptr(), B, G, dout, stream)
    if rc != 0:
        raise RuntimeError(f"gaunt_chain kernel launch failed: CUDA error {rc} "
                           f"(n={n}, d={dims[:n]}, G={G}, dout={dout}, B={B})")
    _STATS["gaunt_chain"] += 1
    return out


def _forward(flat, Ts, P, gs, gb) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    dev = flat[0].device
    if dev.type == "cuda":
        return launch_chain_kernel(flat, Ts, P, gs, gb)
    if dev.type == "cpu":
        return chain_plain(flat, Ts, P, gs, gb)
    raise ValueError(f"unsupported device {dev}")


class _ChainFn(torch.autograd.Function):
    """Kernel forward, collocation VJP backward (reference `_bwd_core` and
    the gated `bwd`, kernels/gaunt_fused.py:225-259):

        U = dout @ P^T,  Ug = U * gs,  dV_i = Ug * prod_{j != i} V_j,
        dx_i = dV_i @ T_i^T,  dgs = rowsum(U * V),  dgb = rowsum(U).

    The backward is plain differentiable torch ops, so it can itself be
    differentiated (create_graph=True)."""

    @staticmethod
    def forward(ctx, Ts, P, gs, gb, *flat):
        ctx.n = len(flat)
        ctx.save_for_backward(P, gs, gb, *Ts, *flat)
        return _forward(flat, Ts, P, gs, gb)

    @staticmethod
    def backward(ctx, dout):
        n = ctx.n
        saved = ctx.saved_tensors
        P, gs, gb = saved[:3]
        Ts, flat = saved[3: 3 + n], saved[3 + n:]
        Vs = [a @ T for a, T in zip(flat, Ts)]
        U = dout @ P.T
        Ug = U if gs is None else U * gs
        grads = []
        for i in range(n):
            if not ctx.needs_input_grad[4 + i]:
                grads.append(None)
                continue
            dV = Ug
            for j in range(n):
                if j != i:
                    dV = dV * Vs[j]
            grads.append(dV @ Ts[i].T)
        dgs = dgb = None
        if gs is not None:
            V = Vs[0]
            for Vj in Vs[1:]:
                V = V * Vj
            dgs = (U * V).sum(-1, keepdim=True)
            dgb = U.sum(-1, keepdim=True)
        return (None, None, dgs, dgb, *grads)


# --------------------------------------------------------------------------
# chain entry points (leading dims, 'grid' entries/exits, gate broadcast)
# --------------------------------------------------------------------------


def _storage_dtype(xs, dtype) -> torch.dtype:
    if dtype is None:
        dt = xs[0].dtype
        for x in xs[1:]:
            dt = torch.promote_types(dt, x.dtype)
        dt = {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(dt, dt)
    else:
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dt == torch.bfloat16:
        raise NotImplementedError("bfloat16 chain storage is not ported yet")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported chain storage dtype {dt}")
    return dt


def _chain_prepare(xs, entries):
    """Broadcast/flatten operands to rows [B, d_i]; 'grid' entries (complex
    half grids [..., 2L+1, L+1]) stack into [Re F; Im F]."""
    flat = []
    for x, e in zip(xs, entries):
        if e == "grid":
            F = x.reshape(*x.shape[:-2], -1)
            x = torch.cat([F.real, F.imag], dim=-1)
        flat.append(x)
    lead = torch.broadcast_shapes(*[a.shape[:-1] for a in flat])
    B = int(np.prod(lead)) if lead else 1
    flat = [a.expand(*lead, a.shape[-1]).reshape(B, a.shape[-1]) for a in flat]
    return flat, lead, B


def _chain_finish(out, lead, Lout: int, out_entry: str):
    if out_entry == "grid":
        half = out.shape[-1] // 2
        F = torch.complex(out[..., :half], out[..., half:])
        return F.reshape(*lead, 2 * Lout + 1, Lout + 1)
    return out.reshape(*lead, out.shape[-1])


def _chain_setup(xs, Ls, Lout, entries, out_entry, dtype, gate):
    Ls = tuple(int(L) for L in Ls)
    Lout = sum(Ls) if Lout is None else int(Lout)
    entries = ("sh",) * len(Ls) if entries is None else tuple(entries)
    if len(xs) != len(Ls) or len(entries) != len(Ls):
        raise ValueError(f"chain got {len(xs)} operands / {len(entries)} entries "
                         f"for degrees {Ls}")
    sdt = _storage_dtype(xs, dtype)
    dev = xs[0].device
    Ts_np, P_np = _const.chain_matrices_folded(Ls, Lout, entries, out_entry,
                                               dtype=str(sdt)[6:])
    Ts = tuple(_const.to_torch(T, dev) for T in Ts_np)
    P = _const.to_torch(P_np, dev)
    flat, lead, B = _chain_prepare(xs, entries)
    flat = [a.to(sdt).contiguous() for a in flat]
    gs = gb = None
    if gate is not None:
        gs, gb = (g.to(sdt).expand(lead).reshape(B, 1).contiguous() for g in gate)
    return Ls, flat, lead, Ts, P, gs, gb


def gaunt_chain_fused_torch(xs, Ls, Lout: int | None = None, *, entries=None,
                            out_entry: str = "sh", dtype=None, gate=None):
    """The chain collocation product as plain torch ops (the twin of the
    reference `gaunt_chain_fused_xla`).

    xs: per-operand tensors — 'sh' entries packed SH [..., (L_i+1)^2],
    'grid' entries complex half grids [..., 2L_i+1, L_i+1]; Lout: exit
    degree (default sum(Ls)); out_entry 'sh' returns [..., (Lout+1)^2],
    'grid' the half product grid; gate: optional (gs, gb) broadcastable to
    the operands' leading shape.
    """
    Ls, flat, lead, Ts, P, gs, gb = _chain_setup(xs, Ls, Lout, entries,
                                                 out_entry, dtype, gate)
    return _chain_finish(chain_plain(flat, Ts, P, gs, gb), lead, sum(Ls), out_entry)


def gaunt_chain_fused_hopper(xs, Ls, Lout: int | None = None, *, entries=None,
                             out_entry: str = "sh", dtype=None, gate=None):
    """The chain collocation product on the Hopper kernel (same arguments as
    `gaunt_chain_fused_torch`).  CUDA operands launch the kernel; CPU
    operands run the plain version inside the same autograd Function."""
    Ls, flat, lead, Ts, P, gs, gb = _chain_setup(xs, Ls, Lout, entries,
                                                 out_entry, dtype, gate)
    out = _ChainFn.apply(Ts, P, gs, gb, *flat)
    return _chain_finish(out, lead, sum(Ls), out_entry)
