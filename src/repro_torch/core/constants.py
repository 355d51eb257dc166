"""The port's constant cache: every precomputed tensor behind one builder.

Each builder is an lru-cached numpy function that computes in float64 /
complex128 and casts once at the end, exactly as the reference
``repro.core.constants`` does, so the two agree bit for bit (tested with
``np.array_equal``).  Torch code reads the constants through `to_torch`,
which caches one tensor per (array, device, dtype): a constant crosses to
the device once per process, not once per call.

Padding of the collocation grid (`chain_matrices(pad_lanes=...)`): the
reference rounds the sample axis G up to a multiple of 128, a TPU lane rule.
The port keeps the option for parity tests, but its consumers call with
``pad_lanes=False``: the Hopper chain kernel walks G itself and needs no
padded columns (main path: G = 196 instead of 256, 23% less work).

The collocation products go further (`chain_matrices_folded`, and
`pair_matrices`, its n = 2 case): with SH entries the torus grid covers the
sphere twice, so they keep one sample per distinct sphere point and sum the
projection rows of the repeats — the same function at about half the
samples (L=6 x 6: 314 of 676; the main-path chain: 86 of 196).

The pair kernel takes those matrices split into TF32 hi and lo parts,
padded and laid out in its tensor-core fragment order
(`pair_matrices_tf32`, `pair_fragments`), once per shape; its bf16 mode
takes T1 and T2 as bf16 in the B-fragment order of ``mma.sync.m16n8k16``
(`pair_fragments_bf16`) beside the same split P.

bfloat16 storage: numpy has no bf16 type, so a builder asked for
``dtype='bfloat16'`` returns float32 arrays whose values are bf16 values
(`bf16_round`: float64 -> float32 -> bf16, to nearest even, as torch's and
ml_dtypes' casts round), and ``to_torch(a, device, torch.bfloat16)`` casts
them exactly.  They equal the reference's ``T.astype('bfloat16')`` bit for
bit (tested).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from . import fourier as _fx
from .irreps import idx
from .so3 import real_clebsch_gordan_block, real_gaunt_tensor, real_sph_harm

__all__ = [
    "y_dense",
    "z_dense",
    "y_packed",
    "z_packed",
    "y_half",
    "z_half",
    "z_half_l0",
    "pack_index",
    "filter_fourier_col",
    "conv_u_index",
    "cg_11_blocks",
    "chain_sample_sh",
    "chain_sample_grid",
    "chain_project_sh",
    "chain_project_grid",
    "chain_matrices",
    "chain_matrices_folded",
    "chain_l0",
    "bf16_bits",
    "bf16_round",
    "fused_matrices",
    "sphere_point_classes",
    "pair_matrices",
    "tf32_split",
    "pair_matrices_tf32",
    "pair_fragments",
    "pair_fragments_bf16",
    "gaunt_dense",
    "quad_sample_sh",
    "quad_project_sh",
    "quad_sample_fourier",
    "quad_project_fourier",
    "to_torch",
    "cache_stats",
    "clear_all",
]


# --------------------------------------------------------------------------
# SH <-> 2D Fourier conversion tensors
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _y_raw(L: int) -> np.ndarray:
    return _fx.sh_to_fourier_dense(L)


@lru_cache(maxsize=None)
def _z_raw(Lf: int, Lout: int) -> np.ndarray:
    return _fx.fourier_to_sh_dense(Lf, Lout)


@lru_cache(maxsize=None)
def y_dense(L: int, cdtype: str = "complex64") -> np.ndarray:
    """sh->Fourier tensor [(L+1)^2, 2L+1 (u), 2L+1 (v)], centered."""
    return _y_raw(L).astype(cdtype)


@lru_cache(maxsize=None)
def z_dense(Lf: int, Lout: int, cdtype: str = "complex64") -> np.ndarray:
    """Fourier->sh tensor [2Lf+1, 2Lf+1, (Lout+1)^2], centered."""
    return _z_raw(Lf, Lout).astype(cdtype)


@lru_cache(maxsize=None)
def y_packed(L: int, cdtype: str = "complex64") -> tuple[np.ndarray, np.ndarray]:
    """Packed (per-|m| block-sparse) sh->Fourier matrices (yp, yn)."""
    yp, yn = _fx.sh_to_fourier_packed(L, y=_y_raw(L))
    return yp.astype(cdtype), yn.astype(cdtype)


@lru_cache(maxsize=None)
def z_packed(Lf: int, Lout: int, cdtype: str = "complex64") -> tuple[np.ndarray, np.ndarray]:
    """Packed Fourier->sh matrices (zp, zn)."""
    zp, zn = _fx.fourier_to_sh_packed(Lf, Lout, z=_z_raw(Lf, Lout))
    return zp.astype(cdtype), zn.astype(cdtype)


@lru_cache(maxsize=None)
def y_half(L: int, cdtype: str = "complex64") -> np.ndarray:
    """Half (Hermitian / real-input) sh->Fourier tensor: v >= 0 columns only."""
    return _fx.sh_to_fourier_half(L, y=_y_raw(L)).astype(cdtype)


@lru_cache(maxsize=None)
def z_half(Lf: int, Lout: int, cdtype: str = "complex64") -> np.ndarray:
    """Half Fourier->sh tensor with the v < 0 columns conjugate-folded in."""
    return _fx.fourier_to_sh_half(Lf, Lout, z=_z_raw(Lf, Lout)).astype(cdtype)


@lru_cache(maxsize=None)
def z_half_l0(Lf: int, cdtype: str = "complex64") -> np.ndarray:
    """The l = 0 row of `z_half` [2Lf+1, Lf+1]: half grid -> SH coefficient 0."""
    return np.ascontiguousarray(z_half(Lf, 0, cdtype)[:, :, 0])


@lru_cache(maxsize=None)
def pack_index(L: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather map packed[plane, mm, l] <- flat idx(l, +-mm); mask for valid."""
    gidx = np.zeros((2, L + 1, L + 1), dtype=np.int32)
    mask = np.zeros((2, L + 1, L + 1), dtype=np.float32)
    for mm in range(L + 1):
        for l in range(mm, L + 1):
            gidx[0, mm, l] = l * l + l + mm
            mask[0, mm, l] = 1.0
            if mm > 0:
                gidx[1, mm, l] = l * l + l - mm
                mask[1, mm, l] = 1.0
    return gidx, mask


# --------------------------------------------------------------------------
# eSCN rotation-aligned path constants
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def filter_fourier_col(L2: int, cdtype: str = "complex64") -> np.ndarray:
    """u-column (v=0) Fourier coefficients of S_{l,0}, stacked [L2+1, 2L2+1]."""
    y = _y_raw(L2)
    cols = np.stack([y[idx(l, 0), :, L2] for l in range(L2 + 1)], axis=0)
    return cols.astype(cdtype)


@lru_cache(maxsize=None)
def conv_u_index(L1: int, L2: int) -> tuple[np.ndarray, np.ndarray]:
    """Index/mask for the banded 1D convolution along u.

    out[u3] = sum_{u1} F1[u1] * k[u3 - u1] with centered indices;
    idx[i3, i1] = i3 - i1 into the kernel array of length 2L2+1.
    """
    n1, n2 = 2 * L1 + 1, 2 * L2 + 1
    N = n1 + n2 - 1
    i3 = np.arange(N)[:, None]
    i1 = np.arange(n1)[None, :]
    k = i3 - i1
    valid = (k >= 0) & (k < n2)
    return np.where(valid, k, 0).astype(np.int32), valid.astype(np.float32)


@lru_cache(maxsize=None)
def cg_11_blocks(L: int) -> tuple[np.ndarray, ...]:
    """CG blocks C_{(l-1,1)->l} for the Wigner-from-rotmat recursion."""
    return tuple(
        real_clebsch_gordan_block(l - 1, 1, l).astype(np.float32)
        for l in range(2, L + 1)
    )


# --------------------------------------------------------------------------
# bfloat16 storage
# --------------------------------------------------------------------------


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """The bfloat16 bit patterns (uint16) of ``a`` rounded through float32
    to the nearest bf16, ties to even: the rounding of torch's
    ``.to(torch.bfloat16)`` and of ml_dtypes' ``astype('bfloat16')``."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    one, half = np.uint32(1), np.uint32(0x7FFF)
    return ((u + half + ((u >> np.uint32(16)) & one)) >> np.uint32(16)).astype(np.uint16)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (`bf16_bits`), held as float32."""
    return (bf16_bits(a).astype(np.uint32) << np.uint32(16)).view(np.float32)


def _cast(a: np.ndarray, dtype: str) -> np.ndarray:
    """A builder's one cast to its storage dtype ('bfloat16': `bf16_round`)."""
    return bf16_round(a) if dtype == "bfloat16" else a.astype(dtype)


# --------------------------------------------------------------------------
# n-way collocation (sample-multiply-project) matrices
# --------------------------------------------------------------------------


def _chain_grid_angles(Ltot: int) -> tuple[int, np.ndarray]:
    """(N, angles) of the alias-free product grid for total degree Ltot.

    A product of bandlimited spherical functions with degrees summing to
    Ltot is bandlimited at Ltot on the torus double cover; N = 2*Ltot + 2
    (> 2*Ltot + 1 and even) samples it alias-free.
    """
    N = 2 * Ltot + 2
    return N, 2 * math.pi * np.arange(N) / N


@lru_cache(maxsize=None)
def chain_sample_sh(L: int, Ltot: int) -> np.ndarray:
    """T [(L+1)^2, G]: real SH of degree <= L sampled on the degree-Ltot
    product grid (float64, unpadded)."""
    N, t = _chain_grid_angles(Ltot)
    tt, pp = np.meshgrid(t, t, indexing="ij")
    xyz = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], -1)
    S = real_sph_harm(L, xyz.reshape(-1, 3))
    return S.T.copy()


@lru_cache(maxsize=None)
def chain_sample_grid(L: int, Ltot: int) -> np.ndarray:
    """T' [2*(2L+1)*(L+1), G]: Fourier-resident entry sampling matrix.

    A resident operand arrives as its Hermitian half grid F [2L+1, L+1];
    its real samples are V[g] = Re(sum_{u, v>=0} c_v F[u,v] e^{i(u t_g + v p_g)})
    with c_0 = 1, c_v = 2, which is one real matmul on [Re F; Im F].
    """
    N, t = _chain_grid_angles(Ltot)
    us = np.arange(-L, L + 1)
    vs = np.arange(0, L + 1)
    Et = np.exp(1j * np.outer(us, t))
    Ep = np.exp(1j * np.outer(vs, t))
    c = np.where(vs == 0, 1.0, 2.0)
    E = np.einsum("ua,vb,v->uvab", Et, Ep, c).reshape((2 * L + 1) * (L + 1), N * N)
    return np.concatenate([E.real, -E.imag], axis=0)


@lru_cache(maxsize=None)
def chain_project_sh(Ltot: int, Lout: int) -> np.ndarray:
    """P [G, (Lout+1)^2]: product-grid samples -> SH degrees <= Lout.

    P[g, k] = Re((1/G) sum_{u,v} e^{-i(u t_g + v p_g)} z^k_{u,v}) — exact,
    because the sampled product is alias-free (float64, unpadded).
    """
    N, t = _chain_grid_angles(Ltot)
    z = _z_raw(Ltot, Lout)
    us = np.arange(-Ltot, Ltot + 1)
    Et = np.exp(-1j * np.outer(t, us))
    P = np.einsum("au,bv,uvk->abk", Et, Et, z).real / (N * N)
    return P.reshape(N * N, -1)


@lru_cache(maxsize=None)
def chain_project_grid(Ltot: int) -> np.ndarray:
    """P' [G, 2*(2Lt+1)*(Lt+1)]: samples -> real-stacked half product grid."""
    N, t = _chain_grid_angles(Ltot)
    us = np.arange(-Ltot, Ltot + 1)
    vs = np.arange(0, Ltot + 1)
    Et = np.exp(-1j * np.outer(t, us))
    Ep = np.exp(-1j * np.outer(t, vs))
    E = np.einsum("au,bv->abuv", Et, Ep).reshape(N * N, -1) / (N * N)
    return np.concatenate([E.real, E.imag], axis=1)


@lru_cache(maxsize=None)
def chain_matrices(Ls: tuple, Lout: int, entries: tuple = None,
                   out_entry: str = "sh", pad_lanes: bool = True,
                   dtype: str = "float32"):
    """Chain collocation matrices ((T_1..T_n), P) for  x1 (x) ... (x) xn.

    entries: per-operand 'sh' (packed SH, `chain_sample_sh`) or 'grid'
    (real-stacked half grid, `chain_sample_grid`); out_entry 'sh' projects
    to degrees <= Lout, 'grid' returns the real-stacked half product grid
    (requires Lout == sum(Ls)).  ``pad_lanes`` rounds G up to a multiple of
    128 with inert zero columns/rows (the reference's TPU lane rule — kept
    for parity; the port's kernel runs unpadded).  ``dtype`` is the storage
    dtype ('float32' | 'bfloat16' | 'float64'); the float64 intermediates
    round once.
    """
    Ls = tuple(int(L) for L in Ls)
    Ltot = sum(Ls)
    entries = ("sh",) * len(Ls) if entries is None else tuple(entries)
    if len(entries) != len(Ls) or any(e not in ("sh", "grid") for e in entries):
        raise ValueError(f"entries must be {len(Ls)} of 'sh'|'grid', got {entries!r}")
    Ts = [chain_sample_sh(L, Ltot) if e == "sh" else chain_sample_grid(L, Ltot)
          for L, e in zip(Ls, entries)]
    if out_entry == "sh":
        P = chain_project_sh(Ltot, Lout)
    elif out_entry == "grid":
        if Lout != Ltot:
            raise ValueError(f"out_entry='grid' keeps the full product grid "
                             f"(L={Ltot}); got Lout={Lout}")
        P = chain_project_grid(Ltot)
    else:
        raise ValueError(f"unknown out_entry {out_entry!r} (expected 'sh'|'grid')")
    if pad_lanes:
        G = Ts[0].shape[1]
        Gp = ((G + 127) // 128) * 128
        Ts = [np.pad(T, [(0, 0), (0, Gp - G)]) for T in Ts]
        P = np.pad(P, [(0, Gp - G), (0, 0)])
    return tuple(_cast(T, dtype) for T in Ts), _cast(P, dtype)


@lru_cache(maxsize=None)
def chain_l0(Ls: tuple, entries: tuple = None) -> np.ndarray:
    """C [d_1, ..., d_n] float64: the l = 0 coefficient of an n-way product
    as a multilinear form over the operands,

        s = einsum('...a,...b,...,ab...->...', x_1, ..., x_n, C),

    the contraction of the sampling matrices against the l = 0 projection
    column — exact.  A gate-fused chain gets its per-row gate scalars from
    it before the kernel runs.
    """
    Ls = tuple(int(L) for L in Ls)
    Ltot = sum(Ls)
    entries = ("sh",) * len(Ls) if entries is None else tuple(entries)
    Ts = [chain_sample_sh(L, Ltot) if e == "sh" else chain_sample_grid(L, Ltot)
          for L, e in zip(Ls, entries)]
    p0 = chain_project_sh(Ltot, 0)[:, 0]
    letters = "abcdefghij"[: len(Ls)]
    expr = ",".join(c + "z" for c in letters) + ",z->" + letters
    return np.einsum(expr, *Ts, p0, optimize=True)


@lru_cache(maxsize=None)
def fused_matrices(L1: int, L2: int, Lout: int, pad_lanes: bool = True,
                   dtype: str = "float32"):
    """Pairwise collocation matrices (T1 [d1,G], T2 [d2,G], P [G,dout]) on
    the full torus grid: the n=2 case of `chain_matrices` (the reference's
    builder, kept for parity; the port's pairwise routes use
    `pair_matrices`)."""
    (T1, T2), P = chain_matrices((L1, L2), Lout, ("sh", "sh"), "sh",
                                 pad_lanes=pad_lanes, dtype=dtype)
    return T1, T2, P


@lru_cache(maxsize=None)
def sphere_point_classes(Ltot: int) -> tuple[np.ndarray, np.ndarray]:
    """(reps, cls) for the degree-Ltot product grid (N = 2*Ltot + 2, sample
    g = a*N + b at (t_a, p_b) = (2 pi a/N, 2 pi b/N)).

    The torus is a double cover of the sphere: (t, p) and (2 pi - t, p + pi)
    are one point, and each pole row (t = 0, t = pi) is one point.
    ``cls[g]`` numbers the distinct points in order of first appearance and
    ``reps[c]`` is the first sample of class c.  Exact index arithmetic, no
    tolerance: the classes are where SH samples agree for every degree.
    """
    N = 2 * Ltot + 2
    h = N // 2
    canon = {}
    cls = np.empty(N * N, dtype=np.int64)
    for a in range(N):
        for b in range(N):
            if a == 0 or a == h:
                point = (a, 0)
            elif a < h:
                point = (a, b)
            else:
                point = (N - a, (b + h) % N)
            cls[a * N + b] = canon.setdefault(point, len(canon))
    reps = np.array([int(np.argmax(cls == c)) for c in range(len(canon))])
    return reps, cls


@lru_cache(maxsize=None)
def chain_matrices_folded(Ls: tuple, Lout: int, entries: tuple = None,
                          out_entry: str = "sh", dtype: str = "float32"):
    """The chain collocation matrices ((T_1..T_n), P) the port's chain routes
    use: `chain_matrices` unpadded, at the distinct sphere points of the
    product grid when every entry is 'sh'.

    Two samples at one sphere point have the same value of every SH
    operand, hence the same product (and the same gated product: the gate
    is per row), so one sample per point, with the projection rows of its
    class summed, computes the same output for any exit (exact up to the
    order of float sums; folded in float64, cast once).  'grid' entries are
    functions on the torus, not on the sphere: a chain with one is returned
    unfolded.
    """
    Ls = tuple(int(L) for L in Ls)
    entries = ("sh",) * len(Ls) if entries is None else tuple(entries)
    if any(e != "sh" for e in entries):
        return chain_matrices(Ls, Lout, entries, out_entry, pad_lanes=False, dtype=dtype)
    Ts, P = chain_matrices(Ls, Lout, entries, out_entry, pad_lanes=False,
                           dtype="float64")
    reps, cls = sphere_point_classes(sum(Ls))
    Pf = np.zeros((len(reps), P.shape[1]))
    np.add.at(Pf, cls, P)
    return (tuple(_cast(np.ascontiguousarray(T[:, reps]), dtype) for T in Ts),
            _cast(Pf, dtype))


@lru_cache(maxsize=None)
def pair_matrices(L1: int, L2: int, Lout: int, dtype: str = "float32"):
    """The port's pairwise collocation matrices (T1 [d1,Gd], T2 [d2,Gd],
    P [Gd,dout]) at the Gd distinct sphere points of the product grid: the
    n = 2 case of `chain_matrices_folded`."""
    (T1, T2), P = chain_matrices_folded((L1, L2), Lout, ("sh", "sh"), "sh", dtype)
    return T1, T2, P


def tf32_split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) float32 with a ~= hi + lo, each a TF32 value (low 13
    mantissa bits zero): hi = a rounded to TF32 (to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``), lo = a - hi (exact in f32) rounded the
    same way.  The two parts keep 22 of a's 24 significant bits, so
    |a - hi - lo| <= 2^-22 |a|; the pair kernel splits its rows the same
    way, bit for bit."""
    def rna(v):
        u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
        return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    a = np.asarray(a, dtype=np.float32)
    hi = rna(a)
    return hi, rna(a - hi)


# the pair kernel's tile sizes: K and N of a tensor-core fragment, and the
# samples of one staged tile
_FRAG = 8
_SAMPLE_TILE = 32
# within each group of 8 samples, the sample at the projection's k-index j:
# the sampling product leaves samples 2t, 2t+1 with the thread that the
# projection asks for k-indices t, t+4
PAIR_SAMPLE_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _pad_to(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(a, [(0, rows - a.shape[0]), (0, cols - a.shape[1])])


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@lru_cache(maxsize=None)
def pair_matrices_tf32(L1: int, L2: int, Lout: int):
    """The pair kernel's constants: `pair_matrices` (f32) split by
    `tf32_split` and zero-padded — d1, d2 and dout to multiples of 8, the
    Gd samples to a multiple of 32 — with P's rows permuted within each
    group of 8 samples as `PAIR_SAMPLE_ORDER`.

    -> (T1hi, T1lo [d1p, Gp], T2hi, T2lo [d2p, Gp], Phi, Plo [Gp, doutp]).
    Zero T columns give zero samples and zero P rows add nothing, so the
    padded product equals the unpadded one.
    """
    T1, T2, P = pair_matrices(L1, L2, Lout)
    Gp = _up(P.shape[0], _SAMPLE_TILE)
    T1 = _pad_to(T1, _up(T1.shape[0], _FRAG), Gp)
    T2 = _pad_to(T2, _up(T2.shape[0], _FRAG), Gp)
    P = _pad_to(P, Gp, _up(P.shape[1], _FRAG))
    order = (np.arange(Gp) // _FRAG) * _FRAG + np.tile(PAIR_SAMPLE_ORDER, Gp // _FRAG)
    return (*tf32_split(T1), *tf32_split(T2), *tf32_split(P[order]))


def _b_fragments(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """[K, N] (K, N multiples of 8) -> [K/8, N/8, 32, 4]: the B operand of
    ``mma.sync.m16n8k8`` tf32 per (k-tile, n-tile), lane l = 4 g + t
    holding (hi[t, g], hi[t+4, g], lo[t, g], lo[t+4, g]) of the tile."""
    K, N = hi.shape
    both = np.stack([hi, lo]).reshape(2, K // 8, 2, 4, N // 8, 8)  # [hl, kt, h, t, nt, g]
    return np.ascontiguousarray(both.transpose(1, 4, 5, 3, 0, 2)).reshape(K // 8, N // 8, 32, 4)


@lru_cache(maxsize=None)
def pair_fragments(L1: int, L2: int, Lout: int):
    """`pair_matrices_tf32` in the pair kernel's fragment order, so that one
    16-byte load gives a thread the hi and lo of its B fragment and one
    tile of 32 samples is one contiguous run:

    -> (F1 [Gp/8, d1p/8, 32, 4], F2 [Gp/8, d2p/8, 32, 4],
        FP [Gp/8, doutp/8, 32, 4]) float32, sample tile first in each.
    """
    T1h, T1l, T2h, T2l, Ph, Pl = pair_matrices_tf32(L1, L2, Lout)
    F1 = np.ascontiguousarray(_b_fragments(T1h, T1l).transpose(1, 0, 2, 3))
    F2 = np.ascontiguousarray(_b_fragments(T2h, T2l).transpose(1, 0, 2, 3))
    return F1, F2, _b_fragments(Ph, Pl)


@lru_cache(maxsize=None)
def pair_fragments_bf16(L1: int, L2: int, Lout: int):
    """The pair kernel's constants in its bf16 mode: T1 and T2 of
    `pair_matrices` at bf16, zero-padded (d to a multiple of 16, the samples
    to a multiple of 32) and in the B-fragment order of
    ``mma.sync.m16n8k16`` bf16 (`_b_fragments_bf16`), beside `pair_fragments`'
    P unchanged (f32 split into TF32 hi and lo, rows permuted as
    `PAIR_SAMPLE_ORDER`: the m16n8k16 accumulator has the m16n8k8 layout).

    -> (F1 [Gp/8, d1p/16, 32, 4] int16, F2 [Gp/8, d2p/16, 32, 4] int16 —
        bf16 bit patterns —, FP [Gp/8, doutp/8, 32, 4] float32).
    """
    T1, T2, _ = pair_matrices(L1, L2, Lout, dtype="bfloat16")
    Gp = _up(T1.shape[1], _SAMPLE_TILE)
    F1, F2 = (np.ascontiguousarray(_b_fragments_bf16(bf16_bits(
        _pad_to(T, _up(T.shape[0], 2 * _FRAG), Gp))).transpose(1, 0, 2, 3))
        for T in (T1, T2))
    return F1, F2, pair_fragments(L1, L2, Lout)[2]


def _b_fragments_bf16(bits: np.ndarray) -> np.ndarray:
    """[K, N] uint16 (K a multiple of 16, N of 8) -> [K/16, N/8, 32, 4] int16:
    the B operand of ``mma.sync.m16n8k16`` bf16 per (k-tile, n-tile), lane
    l = 4 g + t holding (B[2t, g], B[2t+1, g], B[2t+8, g], B[2t+9, g]) — its
    two 32-bit registers, the lower k in the lower half."""
    K, N = bits.shape
    b = bits.reshape(K // 16, 2, 4, 2, N // 8, 8)  # [kt, h, t, j, nt, g]: k = 16kt+8h+2t+j
    return np.ascontiguousarray(b.transpose(0, 4, 5, 2, 1, 3)).reshape(
        K // 16, N // 8, 32, 4).view(np.int16)


# --------------------------------------------------------------------------
# S^2 quadrature matrices (Gauss-Legendre x equispaced phi)
# --------------------------------------------------------------------------
#
# float64 (complex128) by default, equal to the reference's builders bit for
# bit; ``dtype`` casts once ('float32', 'bfloat16' as `bf16_round` values,
# 'complex64' for the complex projection), as every builder here does.


@lru_cache(maxsize=None)
def quad_sample_sh(L: int, n_theta: int, n_phi: int, dtype: str = "float64") -> np.ndarray:
    """A [(L+1)^2, G]: SH coefficients -> quadrature-grid samples."""
    return _cast(_fx.s2quad_sample_sh(L, n_theta, n_phi), dtype)


@lru_cache(maxsize=None)
def quad_project_sh(Lout: int, n_theta: int, n_phi: int, dtype: str = "float64") -> np.ndarray:
    """P [G, (Lout+1)^2]: weighted quadrature projection back onto SH."""
    return _cast(_fx.s2quad_project_sh(Lout, n_theta, n_phi), dtype)


@lru_cache(maxsize=None)
def quad_sample_fourier(L: int, n_theta: int, n_phi: int,
                        dtype: str = "float64") -> np.ndarray:
    """M [2 (2L+1)(L+1), G]: real-stacked half grid -> quadrature samples."""
    return _cast(_fx.s2quad_sample_fourier(L, n_theta, n_phi), dtype)


@lru_cache(maxsize=None)
def quad_project_fourier(L: int, n_theta: int, n_phi: int,
                         dtype: str = "complex128") -> np.ndarray:
    """Z [G, 2L+1, L+1]: quadrature samples -> half grid (complex)."""
    return _fx.s2quad_project_fourier(L, n_theta, n_phi).astype(dtype)


@lru_cache(maxsize=None)
def gaunt_dense(L1: int, L2: int, Lout: int, dtype: str = "float32") -> np.ndarray:
    """The exact dense real-Gaunt tensor [(L1+1)^2, (L2+1)^2, (Lout+1)^2]."""
    return _cast(real_gaunt_tensor(L1, L2, Lout), dtype)


# --------------------------------------------------------------------------
# introspection
# --------------------------------------------------------------------------

_CACHED = (
    _y_raw, _z_raw, y_dense, z_dense, y_packed, z_packed, y_half, z_half, z_half_l0,
    pack_index, filter_fourier_col, conv_u_index, cg_11_blocks, chain_sample_sh,
    chain_sample_grid, chain_project_sh, chain_project_grid, chain_matrices, chain_l0,
    fused_matrices, sphere_point_classes, chain_matrices_folded, pair_matrices,
    pair_matrices_tf32, pair_fragments, pair_fragments_bf16, quad_sample_sh,
    quad_project_sh, quad_sample_fourier, quad_project_fourier, gaunt_dense,
)


def cache_stats() -> dict[str, tuple[int, int, int]]:
    """{builder name: (hits, misses, currsize)} over every cached builder."""
    return {f.__name__: (ci.hits, ci.misses, ci.currsize)
            for f in _CACHED for ci in (f.cache_info(),)}


def clear_all() -> None:
    """Drop every cached constant, and its device copies (tests, memory
    pressure).  A plan built before keeps the tensors it already holds."""
    for f in _CACHED:
        f.cache_clear()
    _TORCH.clear()


# --------------------------------------------------------------------------
# numpy -> torch, once per device
# --------------------------------------------------------------------------

_TORCH: dict = {}


def to_torch(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """The cached torch copy of a builder's numpy constant on ``device``.

    Keys on the array's identity: every builder above is lru-cached, so the
    same constant is the same array object for the life of the process (the
    entry keeps a reference to it, so the id cannot be reused).  Pass a
    builder's array itself: a slice or view made per call is a new object
    and would add an entry at every call.
    """
    dev = torch.device(device)
    key = (id(arr), str(dev), dtype)
    hit = _TORCH.get(key)
    if hit is None:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(device=dev, dtype=dtype)
        hit = _TORCH[key] = (arr, t)
    return hit[1]
