"""The direct full 2D convolution of centred coefficient grids, with its
plain version and its Hopper kernel pair under autograd.

Two operations close under differentiation (square grids, 2D indices,
``*`` the complex conjugate):

    full_conv(A[n1], B[n2]) -> O[N],  O[p] = sum_{i+d=p} A[i] B[d],  N = n1+n2-1
    valid_corr(G[N], K[k])  -> R[m],  R[i] = sum_d G[i+d] K[d],      m = N-k+1

    d full_conv:   gA = valid_corr(gO, B*),  gB = valid_corr(gO, A*)
    d valid_corr:  gG = full_conv(gR, K*),   gK = valid_corr(G*, gR)

each gradient summed over the lead dimensions along which its operand was
broadcast.  `_FullConv` and `_Corr` are autograd Functions whose backwards
call each other, so every order of derivative works with two kernels:

* `full_conv_plain` — the shift-and-add (n2^2 shifted copies of the small
  grid added into the product grid); `valid_corr_plain` — its adjoint, k^2
  shifted windows of G.  The Functions run them under ``no_grad`` on CPU
  tensors, and only there.
* `launch_full_conv` / `launch_adjoint` — the wrappers of
  ``csrc/direct_conv.cu`` (sm_90a): the forward, and one adjoint pass that
  computes both valid_corrs of one G.  They check their inputs, launch on
  the current stream, raise on a launch error and count launches
  (`kernel_stats()['direct_conv']`, ``['direct_conv_adjoint']``).  On a
  CUDA tensor the Functions launch the kernels or raise; nothing falls
  back to the loop.

The Functions take canonical operands [E, C or 1, n, n]: E lead rows, C
channels, and channel count 1 for an operand shared by the channels of its
row (the general conv's filter grid, shared over the 256 channels of an
edge); `full_conv` and `valid_corr` fold any lead broadcast into that form
(expanding an operand only for a pattern the form cannot hold).  A
conjugate view (``B.conj()``) reaches the kernels as a flag, never as a
copy.  The kernels replace no TPU kernel: the reference's 'direct' route is
XLA's ``lax.conv_general_dilated`` (`repro/core/gaunt.py:131`); see the
source's note for the bound and the design.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import load as _load
from .gaunt_fused import add_kernel_launches, register_kernel_counters

__all__ = [
    "full_conv",
    "valid_corr",
    "full_conv_plain",
    "valid_corr_plain",
    "launch_full_conv",
    "launch_adjoint",
]

_LANES = 32        # channels a block of the fast kernels takes at once
_FAST = (3, 5, 7, 9)
_CDTYPES = (torch.complex64, torch.complex128)
_BLOCKS_PER_SM = 8  # blocks of the fast kernels in flight an SM

register_kernel_counters("direct_conv", "direct_conv_adjoint")


# --------------------------------------------------------------------------
# plain versions (any lead broadcast)
# --------------------------------------------------------------------------


def full_conv_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A [..., n1, n1] (*) B [..., n2, n2] -> [..., N, N], N = n1 + n2 - 1:
    out[.., i+di, j+dj] += A[.., i, j] * B[.., di, dj], the n2^2 shifted
    copies of A added in the reference's order (its zero padding adds
    exact zeros)."""
    n1, n2 = A.shape[-1], B.shape[-1]
    N = n1 + n2 - 1
    lead = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    out = A.new_zeros(lead + (N, N), dtype=torch.promote_types(A.dtype, B.dtype))
    for di in range(n2):
        for dj in range(n2):
            out[..., di: di + n1, dj: dj + n1] += A * B[..., di: di + 1, dj: dj + 1]
    return out


def valid_corr_plain(G: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """G [..., N, N] correlated with K [..., k, k] over the windows where K
    lies inside G -> [..., m, m], m = N - k + 1:
    R[.., i, j] = sum_{di,dj} G[.., i+di, j+dj] K[.., di, dj]."""
    N, k = G.shape[-1], K.shape[-1]
    m = N - k + 1
    out = None
    for di in range(k):
        for dj in range(k):
            t = G[..., di: di + m, dj: dj + m] * K[..., di: di + 1, dj: dj + 1]
            out = t if out is None else out + t
    return out


# --------------------------------------------------------------------------
# kernel wrappers (canonical operands)
# --------------------------------------------------------------------------


def _declare(lib) -> None:
    lib.direct_conv_full.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                                     + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.direct_conv_full.restype = ctypes.c_int
    lib.direct_conv_adjoint.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                                        + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.direct_conv_adjoint.restype = ctypes.c_int
    lib.direct_conv_adjoint_fast.argtypes = [ctypes.c_int] * 8
    lib.direct_conv_adjoint_fast.restype = ctypes.c_int


def _fast(n1: int, n2: int, dtype) -> bool:
    """Whether the fast kernels take grids of sizes (n1, n2) at ``dtype``
    (complex64, the sizes the source instantiates; the adjoint asks
    ``direct_conv_adjoint_fast`` besides, for its shared memory)."""
    return dtype == torch.complex64 and n1 in _FAST and n2 in _FAST


@functools.lru_cache(maxsize=None)
def _target_blocks(dev: torch.device) -> int:
    """Blocks of the fast kernels that fill the card ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count * _BLOCKS_PER_SM


def _splits(E: int, C: int, dev: torch.device) -> int:
    """Blocks a row's channel chunks are split over on the fast kernels:
    one block a row where the rows fill the card, more where they do not
    (operands whose leads fold to few rows of many channels)."""
    return min(-(-C // _LANES), max(1, -(-_target_blocks(dev) // max(E, 1))))


def _operand(t: torch.Tensor | None, dev, dtype, what: str):
    """(contiguous tensor without the conjugate bit, conj flag); a tensor
    on another device or of another dtype raises."""
    if t is None:
        return None, 0
    if t.device != dev or dev.type != "cuda":
        raise ValueError(f"the direct conv kernels need every tensor on one CUDA "
                         f"device, got {what} on {t.device} beside {dev}")
    if t.dtype != dtype or dtype not in _CDTYPES:
        raise ValueError(f"the direct conv kernels take complex64 or complex128 "
                         f"operands of one dtype, got {what} {t.dtype} beside {dtype}")
    if t.dim() != 4 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"the direct conv kernels take [E, C, n, n] grids, got {what} "
                         f"{tuple(t.shape)}")
    conj = t.is_conj()
    if conj:
        t = t.conj()
    return t.resolve_neg().contiguous(), int(conj)


def _channels(t: torch.Tensor, E: int, C: int, what: str) -> int:
    """1 when ``t`` is shared by the C channels of its row, else 0."""
    if t.shape[0] != E or t.shape[1] not in (1, C):
        raise ValueError(f"{what} {tuple(t.shape)} does not fit {E} rows of {C} channels")
    return int(t.shape[1] == 1 and C > 1)


def launch_full_conv(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The forward kernel: A [E, Ca, n1, n1] (*) B [E, Cb, n2, n2] ->
    [E, C, N, N], C = max(Ca, Cb), each of Ca, Cb 1 or C; complex64 or
    complex128 on one CUDA device; a conjugate view is read conjugated.
    Raises on anything the kernel does not take and on a launch error."""
    dev, dtype = A.device, A.dtype
    (A, ca), (B, cb) = _operand(A, dev, dtype, "A"), _operand(B, dev, dtype, "B")
    E, C = A.shape[0], max(A.shape[1], B.shape[1])
    a_sh, b_sh = _channels(A, E, C, "A"), _channels(B, E, C, "B")
    if a_sh and not b_sh:  # the fast kernel reads the per-channel grid as A
        A, B, ca, cb, a_sh, b_sh = B, A, cb, ca, b_sh, a_sh
    n1, n2 = A.shape[-1], B.shape[-1]
    N = n1 + n2 - 1
    out = torch.empty((E, C, N, N), device=dev, dtype=dtype)
    if out.numel() == 0:
        return out
    lib = _load("direct_conv", _declare)
    fast = _fast(n1, n2, dtype)
    S = _splits(E, C, dev) if fast else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.direct_conv_full(A.data_ptr(), B.data_ptr(), out.data_ptr(), E, C, n1, n2,
                                  a_sh, b_sh, ca, cb, S, int(fast),
                                  int(dtype == torch.complex128), stream)
    if rc != 0:
        raise RuntimeError(f"direct_conv forward launch failed: CUDA error {rc} "
                           f"({dtype}, E={E}, C={C}, n1={n1}, n2={n2})")
    add_kernel_launches({"direct_conv": 1})
    return out


def launch_adjoint(G: torch.Tensor, K1, K2, c1: int, c2: int):
    """The adjoint kernel over one G [E, C, N, N]: (R1, R2) with
    R1 = valid_corr(G, K1) from K1 [E, 1 or C, n2, n2] and R2 =
    valid_corr(G, K2) from K2 [E, 1 or C, n1, n1], N = n1 + n2 - 1; R_i has
    c_i channels (1 or C; 1 with C > 1: summed over the channels).  A K of
    None skips its output (None).  One launch on the fast kernels, one an
    output on the generic ones (other sizes, complex128, or operands whose
    chunks overflow a block's shared memory)."""
    dev, dtype = G.device, G.dtype
    G, cg = _operand(G, dev, dtype, "G")
    (K1, ck1), (K2, ck2) = _operand(K1, dev, dtype, "K1"), _operand(K2, dev, dtype, "K2")
    E, C, N = G.shape[0], G.shape[1], G.shape[-1]
    n2 = K1.shape[-1] if K1 is not None else N + 1 - K2.shape[-1]
    n1 = N + 1 - n2
    if n1 < 1 or (K2 is not None and K2.shape[-1] != n1):
        raise ValueError(f"kernels {None if K1 is None else tuple(K1.shape)}, "
                         f"{None if K2 is None else tuple(K2.shape)} do not fit G "
                         f"{tuple(G.shape)}")
    for c in (c1, c2):
        if c not in (1, C):
            raise ValueError(f"an output takes 1 or {C} channels, not {c}")
    k1_sh = _channels(K1, E, C, "K1") if K1 is not None else 0
    k2_sh = _channels(K2, E, C, "K2") if K2 is not None else 0
    r1_sum, r2_sum = int(c1 == 1 and C > 1), int(c2 == 1 and C > 1)
    lib = _load("direct_conv", _declare)
    fast = _fast(n1, n2, dtype) and bool(lib.direct_conv_adjoint_fast(
        n1, n2, int(K1 is not None), int(K2 is not None), k1_sh, k2_sh, r1_sum, r2_sum))
    S = _splits(E, C, dev) if fast else 1

    def out(K, n, r_sum):
        if K is None:
            return None
        shape = (S, E, n, n) if r_sum else (E, C, n, n)
        return torch.empty(shape, device=dev, dtype=dtype)

    R1, R2 = out(K1, n1, r1_sum), out(K2, n2, r2_sum)
    if E > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.direct_conv_adjoint(
                G.data_ptr(), _ptr(K1), _ptr(K2), _ptr(R1), _ptr(R2), E, C, n1, n2,
                k1_sh, k2_sh, r1_sum, r2_sum, S, cg, ck1, ck2, int(fast),
                int(dtype == torch.complex128), stream)
        if rc != 0:
            raise RuntimeError(f"direct_conv adjoint launch failed: CUDA error {rc} "
                               f"({dtype}, E={E}, C={C}, n1={n1}, n2={n2}, S={S})")
        add_kernel_launches({"direct_conv_adjoint":
                             1 if fast else (K1 is not None) + (K2 is not None)})
    R1 = _summed(R1, r1_sum, E, n1)
    R2 = _summed(R2, r2_sum, E, n2)
    return R1, R2


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _summed(R, r_sum: int, E: int, n: int):
    """A summed output's S partials [S, E, n, n] -> [E, 1, n, n]."""
    if R is None or not r_sum:
        return R
    return (R[0] if R.shape[0] == 1 else R.sum(0)).reshape(E, 1, n, n)


# --------------------------------------------------------------------------
# the autograd Functions (canonical operands)
# --------------------------------------------------------------------------


def _full(A, B):
    if A.device.type == "cuda":
        return launch_full_conv(A, B)
    if A.device.type == "cpu" and B.device.type == "cpu":
        with torch.no_grad():
            return full_conv_plain(A, B)
    raise ValueError(f"the direct conv kernels need every tensor on one CUDA device, "
                     f"got {A.device} and {B.device}")


def _reduce(R, c: int):
    """A per-channel plain result summed to ``c`` channels."""
    return R.sum(1, keepdim=True) if c == 1 and R.shape[1] != 1 else R


def _adjoint(G, K1, K2, c1: int, c2: int):
    if G.device.type == "cuda":
        return launch_adjoint(G, K1, K2, c1, c2)
    if G.device.type == "cpu" and all(K is None or K.device.type == "cpu" for K in (K1, K2)):
        with torch.no_grad():
            return tuple(None if K is None else _reduce(valid_corr_plain(G, K), c)
                         for K, c in ((K1, c1), (K2, c2)))
    raise ValueError(f"the direct conv kernels need every tensor on one CUDA device, "
                     f"got G on {G.device}")


class _FullConv(torch.autograd.Function):
    """O = full_conv(A, B) on canonical operands; backward one adjoint pass:
    (gA, gB) = (valid_corr(gO, B*), valid_corr(gO, A*)), each summed to
    its operand's channels (`_Corr`)."""

    @staticmethod
    def forward(ctx, A, B):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(A, B)
        return _full(A, B)

    @staticmethod
    def backward(ctx, gO):
        if gO is None:
            return None, None
        A, B = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad
        return _Corr.apply(gO, B.conj() if need_a else None, A.conj() if need_b else None,
                           A.shape[1], B.shape[1])


class _Corr(torch.autograd.Function):
    """(R1, R2) = (valid_corr(G, K1), valid_corr(G, K2)) on canonical
    operands, R_i summed to c_i channels; a K of None gives None.  Backward:
    gG = full_conv(gR1, K1*) + full_conv(gR2, K2*) and
    (gK1, gK2) = _Corr(G*, gR1, gR2) summed to the K's channels."""

    @staticmethod
    def forward(ctx, G, K1, K2, c1, c2):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(G, K1, K2)
        return _adjoint(G, K1, K2, c1, c2)

    @staticmethod
    def backward(ctx, gR1, gR2):
        G, K1, K2 = ctx.saved_tensors
        need_g, need_k1, need_k2 = ctx.needs_input_grad[:3]
        gG = None
        if need_g:
            for gR, K in ((gR1, K1), (gR2, K2)):
                if gR is not None:
                    t = _FullConv.apply(gR, K.conj())
                    gG = t if gG is None else gG + t
        X1 = gR1 if need_k1 else None
        X2 = gR2 if need_k2 else None
        gK1 = gK2 = None
        if X1 is not None or X2 is not None:
            gK1, gK2 = _Corr.apply(G.conj(), X1, X2,
                                   K1.shape[1] if K1 is not None else 1,
                                   K2.shape[1] if K2 is not None else 1)
        return gG, gK1, gK2, None, None


# --------------------------------------------------------------------------
# entry points (any lead broadcast)
# --------------------------------------------------------------------------


def _canonical(a: torch.Tensor, b: torch.Tensor):
    """Fold the lead dims of two grids into the Functions' [E, C or 1, n, n]:
    the first split point k at which both operands are whole over
    lead[:k] and each is either whole or broadcast (size 1) over all of
    lead[k:].  A pattern with no such split expands both operands (their
    gradients sum back through the expand).  -> (a4, b4, lead)."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    r = len(lead)
    la = (1,) * (r - a.dim() + 2) + tuple(a.shape[:-2])
    lb = (1,) * (r - b.dim() + 2) + tuple(b.shape[:-2])
    for k in range(r + 1):
        head = all(la[j] == lead[j] == lb[j] for j in range(k))
        kinds = []
        for lx in (la, lb):
            whole = all(lx[j] == lead[j] for j in range(k, r))
            ones = all(lx[j] == 1 for j in range(k, r))
            kinds.append(whole if whole else (False if not ones else None))
        if head and all(kd is not False for kd in kinds):
            E, C = math.prod(lead[:k]), math.prod(lead[k:])
            return (a.reshape(E, C if kinds[0] else 1, *a.shape[-2:]),
                    b.reshape(E, C if kinds[1] else 1, *b.shape[-2:]), lead)
    E = math.prod(lead)
    return (a.expand(*lead, *a.shape[-2:]).reshape(1, E, *a.shape[-2:]),
            b.expand(*lead, *b.shape[-2:]).reshape(1, E, *b.shape[-2:]), lead)


def _square(t: torch.Tensor, what: str) -> None:
    if t.dim() < 2 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"the direct conv takes square grids [..., n, n], got {what} "
                         f"{tuple(t.shape)}")


def full_conv(F1: torch.Tensor, F2: torch.Tensor) -> torch.Tensor:
    """The full 2D convolution F1 [..., n1, n1] (*) F2 [..., n2, n2] ->
    [..., N, N], N = n1 + n2 - 1, lead dims broadcast; differentiable to
    any order.  The kernel pair on CUDA tensors, the plain version on CPU
    tensors (only there)."""
    _square(F1, "F1")
    _square(F2, "F2")
    dt = torch.promote_types(F1.dtype, F2.dtype)
    a, b, lead = _canonical(F1.to(dt), F2.to(dt))
    out = _FullConv.apply(a, b)
    return out.reshape(*lead, *out.shape[-2:])


def valid_corr(G: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """The valid correlation of G [..., N, N] with K [..., k, k] -> [..., m,
    m], m = N - k + 1, lead dims broadcast; differentiable to any order
    (the adjoint of `full_conv` in either operand)."""
    _square(G, "G")
    _square(K, "K")
    if K.shape[-1] > G.shape[-1]:
        raise ValueError(f"K {tuple(K.shape)} is larger than G {tuple(G.shape)}")
    dt = torch.promote_types(G.dtype, K.dtype)
    g, k, lead = _canonical(G.to(dt), K.to(dt))
    if g.shape[1] != max(g.shape[1], k.shape[1]):  # the Functions' G is per channel
        g = g.expand(g.shape[0], k.shape[1], *g.shape[-2:])
    out, _ = _Corr.apply(g, k, None, g.shape[1], 1)
    return out.reshape(*lead, *out.shape[-2:])
