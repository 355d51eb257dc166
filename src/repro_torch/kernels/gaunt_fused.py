"""The Gaunt collocation products — the n-way chain and the pairwise
product — each with its plain version and its Hopper kernel wrapper.

Pairwise (the reference's ``gaunt_fused_pallas``):

    out = ((x1 @ T1) * (x2 @ T2)) @ P

on the distinct sphere points of the product grid
(`core.constants.pair_matrices`):

* `pair_plain` — the kernel's plain PyTorch version (matmuls);
  `gaunt_fused_torch` runs it behind the ``fused_torch`` pairwise backend.
* `launch_pair_kernel` — the wrapper of ``csrc/gaunt_pair.cu`` (sm_90a,
  both products on tensor cores; f32 storage in 3xTF32, bf16 storage with
  bf16 sampling products): takes the folded matrices in the kernel's
  fragment order (`pair_kernel_constants`), checks its inputs, launches on
  the current stream, raises on a launch error, and counts launches
  (`kernel_stats()['gaunt_pair']`, ``['gaunt_pair_bf16']``).
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
  (``csrc/gaunt_chain.cu``, sm_90a, f32 or bf16 storage).  It checks its
  inputs, launches on the current stream, raises on a launch error, and
  counts launches (`kernel_stats`).
* `gaunt_chain_fused_hopper` — the `fused_hopper` chain backend: an
  autograd Function whose forward runs the kernel on CUDA tensors (and the
  plain version on CPU tensors — only there) and whose backward is the
  reference's collocation VJP as differentiable torch ops, so a double
  backward works too.

Storage (the reference's ``_storage_dtype``): operands and the sampling
matrices T_i are held at the storage dtype — float32, bfloat16, or float64
on the plain path — while P, the gate scalars, every sum and the output
stay at the accumulation dtype (float32; float64 for float64 storage).
The plain versions upcast bf16 operands before their matmuls, as the
reference's ``preferred_element_type=f32`` does (a bf16 matmul on the card
would return bf16).
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
    "add_kernel_launches",
    "register_kernel_counters",
]

# launches of each CUDA kernel and storage mode since the last reset
# (ticked in `launch_chain_kernel` / `launch_pair_kernel`, once per kernel
# launch, by the wrappers of other modules that register their counters,
# and by a CUDA graph's replay: `add_kernel_launches`)
_STATS = {"gaunt_chain": 0, "gaunt_chain_bf16": 0, "gaunt_pair": 0, "gaunt_pair_bf16": 0}


def kernel_stats() -> dict:
    """Launches since the last reset per kernel and storage mode:
    'gaunt_chain' and 'gaunt_pair' at f32, 'gaunt_chain_bf16' and
    'gaunt_pair_bf16' at bf16, and the counters other wrappers register
    (`register_kernel_counters`: the direct conv's 'direct_conv' and
    'direct_conv_adjoint')."""
    return dict(_STATS)


def register_kernel_counters(*names: str) -> None:
    """Add counters of another module's kernels to `kernel_stats`, at zero
    (a name already there keeps its count); the module ticks them with
    `add_kernel_launches`."""
    for k in names:
        _STATS.setdefault(k, 0)


def reset_kernel_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def add_kernel_launches(counts: dict) -> None:
    """Add launches the wrappers did not make themselves: a CUDA graph's
    replay launches again every kernel captured in it, and its capture
    launches none (`serve/pools.py` counts a graph's kernels at capture)."""
    for k, v in counts.items():
        _STATS[k] += v


# --------------------------------------------------------------------------
# pairwise: matrices, plain version, kernel wrapper, entry points
# --------------------------------------------------------------------------


def gaunt_fused_matrices(L1: int, L2: int, Lout: int, pad_lanes: bool = True,
                         dtype: str = "float32"):
    """Numpy (T1 [d1,G], T2 [d2,G], P [G,dout]) on the full torus grid, as
    the reference builds them (`core.constants.fused_matrices`).  The
    port's routes use the folded `core.constants.pair_matrices`."""
    return _const.fused_matrices(L1, L2, Lout, pad_lanes, dtype=dtype)




# --------------------------------------------------------------------------
# storage: the reference's rule, and the constants at a storage dtype
# --------------------------------------------------------------------------


def _storage_dtype(xs, dtype) -> torch.dtype:
    """The storage dtype of a product (the reference's ``_storage_dtype``):
    an explicit ``dtype`` wins; otherwise the operands' promotion decides —
    bfloat16 only when every operand is bf16 (a mixed bf16/f32 chain
    promotes to f32) — and complex operands map to their real width.  Any
    other dtype stores at float32."""
    if dtype is None:
        dt = xs[0].dtype
        for x in xs[1:]:
            dt = torch.promote_types(dt, x.dtype)
        dt = {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(dt, dt)
    else:
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return dt if dt in (torch.float32, torch.bfloat16, torch.float64) else torch.float32


def _acc_dtype(sdt: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a storage dtype: f32, f64 for f64."""
    return torch.float64 if sdt == torch.float64 else torch.float32


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _stored(arr: np.ndarray, device, sdt: torch.dtype) -> torch.Tensor:
    """A constant built at storage dtype ``sdt`` as a tensor of that dtype
    (bf16 builders hold bf16 values in float32 arrays)."""
    return _const.to_torch(arr, device, torch.bfloat16 if sdt == torch.bfloat16 else None)


# --------------------------------------------------------------------------
# pairwise: plain version, kernel wrapper, entry points
# --------------------------------------------------------------------------


def pair_plain(x1, x2, T1, T2, P) -> torch.Tensor:
    """The pairwise collocation product in torch ops: rows [B, d1], [B, d2]
    -> [B, dout] at P's dtype (bf16 rows and T upcast first)."""
    acc = P.dtype
    return ((x1.to(acc) @ T1.to(acc)) * (x2.to(acc) @ T2.to(acc))) @ P


def _declare_pair(lib) -> None:
    for name in ("gaunt_pair_forward", "gaunt_pair_forward_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("gaunt_pair_smem_bytes", "gaunt_pair_bf16_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 3
        getattr(lib, name).restype = ctypes.c_size_t


def pair_kernel_constants(L1: int, L2: int, Lout: int, device, dtype=torch.float32):
    """The pair kernel's constants on ``device`` for storage ``dtype``:
    (F1, F2, FP, dout).  At float32 the folded matrices split into TF32 hi
    and lo (`core.constants.pair_fragments`); at bfloat16 T1 and T2 as bf16
    bit patterns (int16) in the m16n8k16 B-fragment order beside the same
    split P (`core.constants.pair_fragments_bf16`).  Zero-padded, in the
    kernel's fragment order, built once per shape and cached per device."""
    build = (_const.pair_fragments_bf16 if dtype == torch.bfloat16
             else _const.pair_fragments)
    F1, F2, FP = (_const.to_torch(a, device) for a in build(L1, L2, Lout))
    return F1, F2, FP, (Lout + 1) ** 2


def launch_pair_kernel(x1, x2, F1, F2, FP, dout: int) -> torch.Tensor:
    """Run the CUDA pairwise kernel: rows x1 [B, d1], x2 [B, d2] with the
    fragments of `pair_kernel_constants` (contiguous, on one CUDA device)
    -> [B, dout] f32.

    float32 rows take F1 [NS, ceil(d1/8), 32, 4], F2 [NS, ceil(d2/8), 32, 4]
    float32; bfloat16 rows take F1 [NS, ceil(d1/16), 32, 4], F2 [NS,
    ceil(d2/16), 32, 4] int16 (bf16 bits).  FP [NS, ceil(dout/8), 32, 4] is
    float32 in both; NS a multiple of 4.  Raises on anything the kernel does
    not take and on a launch error; never falls back."""
    dev = x1.device
    bf16 = x1.dtype == torch.bfloat16
    xdt, fdt = (torch.bfloat16, torch.int16) if bf16 else (torch.float32, torch.float32)
    for t, want in ((x1, xdt), (x2, xdt), (F1, fdt), (F2, fdt), (FP, torch.float32)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"the pair kernel needs every tensor on one CUDA "
                             f"device, got {t.device} beside {dev}")
        if t.dtype != want:
            raise ValueError(f"the pair kernel takes float32 or bfloat16 rows with "
                             f"their fragments (pair_kernel_constants); got {t.dtype} "
                             f"where {want} belongs beside {x1.dtype} rows")
        if not t.is_contiguous():
            raise ValueError("the pair kernel takes contiguous tensors")
    if x1.dim() != 2 or x2.dim() != 2:
        raise ValueError("the pair kernel takes rows [B, d]")
    B, d1 = x1.shape
    d2 = x2.shape[1]
    NS = F1.shape[0]
    k = 16 if bf16 else 8
    want = ((NS, -(-d1 // k), 32, 4), (NS, -(-d2 // k), 32, 4), (NS, -(-dout // 8), 32, 4))
    if (x2.shape[0] != B or NS % 4 or dout <= 0
            or (tuple(F1.shape), tuple(F2.shape), tuple(FP.shape)) != want):
        raise ValueError(f"operands {tuple(x1.shape)}, {tuple(x2.shape)} and fragments "
                         f"{tuple(F1.shape)}, {tuple(F2.shape)}, {tuple(FP.shape)} "
                         f"do not fit dout={dout}")
    lib = _load("gaunt_pair", _declare_pair)
    smem = lib.gaunt_pair_bf16_smem_bytes if bf16 else lib.gaunt_pair_smem_bytes
    if smem(d1, d2, dout) == 0:
        raise ValueError(f"the pair kernel does not take d1={d1}, d2={d2}, "
                         f"dout={dout} (up to d = 136 fits at f32, any dout)")
    out = torch.empty((B, dout), device=dev, dtype=torch.float32)
    if B == 0:
        return out
    fn = lib.gaunt_pair_forward_bf16 if bf16 else lib.gaunt_pair_forward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x1.data_ptr(), x2.data_ptr(), F1.data_ptr(), F2.data_ptr(),
                FP.data_ptr(), out.data_ptr(), B, d1, d2, dout, NS, stream)
    if rc != 0:
        raise RuntimeError(f"gaunt_pair kernel launch failed: CUDA error {rc} "
                           f"({x1.dtype}, d1={d1}, d2={d2}, NS={NS}, dout={dout}, B={B})")
    _STATS["gaunt_pair_bf16" if bf16 else "gaunt_pair"] += 1
    return out


def _pair_storage(x1, x2, dtype) -> torch.dtype:
    """The pairwise products store at f32 or bf16 (the reference's pairwise
    kernel has no f64 storage)."""
    sdt = _storage_dtype((x1, x2), dtype)
    return torch.float32 if sdt == torch.float64 else sdt


def _pair_rows(x1, x2, sdt):
    """Rows [B, d] at storage ``sdt`` (leading dims broadcast)."""
    if x1.device != x2.device:
        raise ValueError(f"operands on {x1.device} and {x2.device}")
    lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
    B = int(np.prod(lead)) if lead else 1
    rows = [a.to(sdt).expand(*lead, a.shape[-1]).reshape(B, a.shape[-1])
            for a in (x1, x2)]
    return rows, lead


def _pair_matrices(L1: int, L2: int, Lout: int, device, sdt):
    """(T1, T2 at ``sdt``, P at f32) on ``device``: the folded matrices."""
    T1, T2, _ = _const.pair_matrices(L1, L2, Lout, dtype=_dtype_name(sdt))
    P = _const.pair_matrices(L1, L2, Lout)[2]
    return _stored(T1, device, sdt), _stored(T2, device, sdt), _const.to_torch(P, device)


def gaunt_fused_torch(x1, x2, L1: int, L2: int, Lout: int | None = None,
                      dtype=None) -> torch.Tensor:
    """The pairwise collocation product as plain torch ops (the twin of the
    reference's ``fused_xla`` route): x1 [..., (L1+1)^2], x2 [...,
    (L2+1)^2] -> [..., (Lout+1)^2] f32, differentiable.  ``dtype`` is the
    storage dtype (None: `_storage_dtype` of the operands)."""
    Lout = L1 + L2 if Lout is None else int(Lout)
    sdt = _pair_storage(x1, x2, dtype)
    (a1, a2), lead = _pair_rows(x1, x2, sdt)
    out = pair_plain(a1, a2, *_pair_matrices(L1, L2, Lout, a1.device, sdt))
    return out.reshape(*lead, out.shape[-1])


def gaunt_fused_hopper(x1, x2, L1: int, L2: int, Lout: int | None = None,
                       dtype=None) -> torch.Tensor:
    """The pairwise collocation product on the Hopper kernel (same arguments
    as `gaunt_fused_torch`; Lout defaults to L1 + L2).

    CUDA operands launch the kernel in the storage dtype's mode; CPU
    operands run the plain version.  The kernel route has no gradient, like
    the reference's Pallas kernel: with grad mode on, a CUDA input that
    requires grad raises rather than return a result cut off from the
    graph."""
    kernel = x1.device.type != "cpu" or x2.device.type != "cpu"
    if kernel and torch.is_grad_enabled() and (x1.requires_grad or x2.requires_grad):
        raise RuntimeError("the gaunt_pair kernel has no gradient: call it under "
                           "torch.no_grad() or on inputs that do not require "
                           "grad, or plan a differentiable backend")
    Lout = L1 + L2 if Lout is None else int(Lout)
    sdt = _pair_storage(x1, x2, dtype)
    (a1, a2), lead = _pair_rows(x1, x2, sdt)
    if kernel:
        out = launch_pair_kernel(a1.contiguous(), a2.contiguous(),
                                 *pair_kernel_constants(L1, L2, Lout, a1.device, sdt))
    else:
        out = pair_plain(a1, a2, *_pair_matrices(L1, L2, Lout, a1.device, sdt))
    return out.reshape(*lead, out.shape[-1])


# --------------------------------------------------------------------------
# chain: the plain version and the kernel wrapper (row layout [B, d])
# --------------------------------------------------------------------------


def chain_plain(flat, Ts, P, gs=None, gb=None) -> torch.Tensor:
    """The collocation product in torch ops: rows [B, d_i] -> [B, dout] at
    P's dtype (bf16 rows and T upcast first)."""
    acc = P.dtype
    v = flat[0].to(acc) @ Ts[0].to(acc)
    for a, T in zip(flat[1:], Ts[1:]):
        v = v * (a.to(acc) @ T.to(acc))
    if gs is not None:
        v = v * gs + gb
    return v @ P


def _declare_chain(lib) -> None:
    for name in ("gaunt_chain_forward", "gaunt_chain_forward_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def launch_chain_kernel(flat, Ts, P, gs=None, gb=None) -> torch.Tensor:
    """Run the CUDA chain kernel: rows [B, d_i] and T_i [d_i, G] all f32 or
    all bf16, P [G, dout] and the gate scalars [B, 1] f32 (contiguous, on
    one CUDA device) -> [B, dout] f32.  Raises on anything the kernel does
    not take and on a launch error; never falls back."""
    n = len(flat)
    if not 2 <= n <= 4 or len(Ts) != n:
        raise ValueError(f"the chain kernel takes 2..4 operands with one T each, "
                         f"got {n} operands and {len(Ts)} matrices")
    dev = flat[0].device
    sdt = flat[0].dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the chain kernel takes float32 or bfloat16 storage, got {sdt}")
    tensors = ([(t, sdt) for t in (*flat, *Ts)] + [(P, torch.float32)]
               + ([(gs, torch.float32), (gb, torch.float32)] if gs is not None else []))
    for t, want in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"the chain kernel needs every tensor on one CUDA "
                             f"device, got {t.device} beside {dev}")
        if t.dtype != want:
            raise ValueError(f"the chain kernel takes rows and T at one storage dtype "
                             f"({sdt}) and P and the gate at float32, got {t.dtype} "
                             f"where {want} belongs")
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
    bf16 = sdt == torch.bfloat16
    ptrs = [a.data_ptr() for a in flat] + [0] * (4 - n)
    tptrs = [T.data_ptr() for T in Ts] + [0] * (4 - n)
    dims = [a.shape[1] for a in flat] + [0] * (4 - n)
    lib = _load("gaunt_chain", _declare_chain)
    fn = lib.gaunt_chain_forward_bf16 if bf16 else lib.gaunt_chain_forward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, *tptrs, *dims, n, P.data_ptr(),
                gs.data_ptr() if gs is not None else None,
                gb.data_ptr() if gb is not None else None,
                out.data_ptr(), B, G, dout, stream)
    if rc != 0:
        raise RuntimeError(f"gaunt_chain kernel launch failed: CUDA error {rc} "
                           f"({sdt}, n={n}, d={dims[:n]}, G={G}, dout={dout}, B={B})")
    _STATS["gaunt_chain_bf16" if bf16 else "gaunt_chain"] += 1
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

    V_i and U are formed at P's accumulation dtype from the stored operands
    (the reference's ``preferred_element_type``), and each dx_i comes back
    at its operand's storage dtype.  The backward is plain differentiable
    torch ops, so it can itself be differentiated (create_graph=True)."""

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
        acc = P.dtype
        Ta = [T.to(acc) for T in Ts]
        Vs = [a.to(acc) @ T for a, T in zip(flat, Ta)]
        U = dout.to(acc) @ P.T
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
            grads.append((dV @ Ta[i].T).to(flat[i].dtype))
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
    """Rows and T_i at the storage dtype; P and the gate scalars at the
    accumulation dtype."""
    Ls = tuple(int(L) for L in Ls)
    Lout = sum(Ls) if Lout is None else int(Lout)
    entries = ("sh",) * len(Ls) if entries is None else tuple(entries)
    if len(xs) != len(Ls) or len(entries) != len(Ls):
        raise ValueError(f"chain got {len(xs)} operands / {len(entries)} entries "
                         f"for degrees {Ls}")
    sdt = _storage_dtype(xs, dtype)
    acc = _acc_dtype(sdt)
    dev = xs[0].device
    Ts_np, _ = _const.chain_matrices_folded(Ls, Lout, entries, out_entry,
                                            dtype=_dtype_name(sdt))
    _, P_np = _const.chain_matrices_folded(Ls, Lout, entries, out_entry,
                                           dtype=_dtype_name(acc))
    Ts = tuple(_stored(T, dev, sdt) for T in Ts_np)
    P = _const.to_torch(P_np, dev)
    flat, lead, B = _chain_prepare(xs, entries)
    flat = [a.to(sdt).contiguous() for a in flat]
    gs = gb = None
    if gate is not None:
        gs, gb = (g.to(acc).expand(lead).reshape(B, 1).contiguous() for g in gate)
    return Ls, flat, lead, Ts, P, gs, gb


def gaunt_chain_fused_torch(xs, Ls, Lout: int | None = None, *, entries=None,
                            out_entry: str = "sh", dtype=None, gate=None):
    """The chain collocation product as plain torch ops (the twin of the
    reference `gaunt_chain_fused_xla`).

    xs: per-operand tensors — 'sh' entries packed SH [..., (L_i+1)^2],
    'grid' entries complex half grids [..., 2L_i+1, L_i+1]; Lout: exit
    degree (default sum(Ls)); out_entry 'sh' returns [..., (Lout+1)^2],
    'grid' the half product grid; dtype: the storage dtype ('float32' |
    'bfloat16' | 'float64'; None: `_storage_dtype` of the operands); gate:
    optional (gs, gb) broadcastable to the operands' leading shape.  The
    output is at the accumulation dtype (f32; f64 for f64 storage).
    """
    Ls, flat, lead, Ts, P, gs, gb = _chain_setup(xs, Ls, Lout, entries,
                                                 out_entry, dtype, gate)
    return _chain_finish(chain_plain(flat, Ts, P, gs, gb), lead, sum(Ls), out_entry)


def gaunt_chain_fused_hopper(xs, Ls, Lout: int | None = None, *, entries=None,
                             out_entry: str = "sh", dtype=None, gate=None):
    """The chain collocation product on the Hopper kernel (same arguments as
    `gaunt_chain_fused_torch`).  CUDA operands launch the kernel in the
    storage dtype's mode; CPU operands run the plain version inside the
    same autograd Function."""
    Ls, flat, lead, Ts, P, gs, gb = _chain_setup(xs, Ls, Lout, entries,
                                                 out_entry, dtype, gate)
    out = _ChainFn.apply(Ts, P, gs, gb, *flat)
    return _chain_finish(out, lead, sum(Ls), out_entry)
