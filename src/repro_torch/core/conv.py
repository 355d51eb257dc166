"""Equivariant convolution (paper §3.3, class 2): x_i (x)_Gaunt Y(r_ij).

Two paths, tested equal:

general : the paper's own method: evaluate the SH filter Y(r_hat), move it
          to the 2D Fourier basis, and run the Gaunt tensor product as a 2D
          convolution of the two grids (a pairwise spectral plan; with
          `EquivariantConv.filter_rep` the filter's grid is built once per
          geometry and reused by every layer).
escn    : rotate the frame so the edge lands on the zenith; the filter then
          has only m = 0 components, S_{l,m}(e_z) = delta_{m0}
          sqrt((2l+1)/4pi), its torus grid is the single v = 0 column, and
          the 2D convolution degenerates to a banded 1D convolution along u:
          out = D^T [ (D x) (x)_Gaunt Y(e_z) ].

Wigner rotations are built differentiably from the rotation matrix by the CG
intertwiner recursion  D^l = C^T (D^{l-1} (x) D^1) C, so forces flow through
the geometry.  `edge_frame_wigner` cuts the blocks to the orders |m| <= m_max
of an edge frame (EquiformerV2's SO(2) convolutions), in `edge_frame_index`'s
m-primary order.
"""
from __future__ import annotations

import dataclasses

import torch

from functools import lru_cache

import numpy as np
import torch.nn.functional as F

from . import constants as _const
from . import engine as _engine
from .engine import build_escn

__all__ = [
    "axis_vector",
    "align_rotation",
    "wigner_blocks_from_rotmat",
    "apply_wigner_blocks",
    "edge_frame_index",
    "edge_frame_wigner",
    "WignerBlocks",
    "EquivariantConv",
]


def axis_vector(axis: int, like: torch.Tensor) -> torch.Tensor:
    """The unit vector along ``axis`` (0, 1, 2: x, y, z) at ``like``'s dtype
    and device, made there: a fill, never a copy from the host, so a step
    captured into a CUDA graph may build it."""
    e = like.new_zeros(3)
    e[axis:axis + 1].fill_(1.0)
    return e


def align_rotation(rhat: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit vectors -> rotation matrices R with R @ rhat = e_z."""
    r = rhat / torch.linalg.norm(rhat, dim=-1, keepdim=True)
    ex = axis_vector(0, r).expand_as(r)
    ez = axis_vector(2, r).expand_as(r)
    use_z = (r[..., 0:1].abs() > 0.9).to(r.dtype)
    u = use_z * ez + (1 - use_z) * ex
    b1 = torch.linalg.cross(u, r, dim=-1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(r, b1, dim=-1)
    return torch.stack([b1, b2, r], dim=-2)


def wigner_blocks_from_rotmat(L: int, R: torch.Tensor) -> list:
    """Real Wigner-D blocks [D^0, ..., D^L] for rotation matrices R [..., 3, 3]:
    D^1 = P R P^T with P the (x,y,z) -> (y,z,x) reordering, then
    D^l = C^T (D^{l-1} (x) D^1) C."""
    Ds = [R.new_ones(R.shape[:-2] + (1, 1))]
    if L == 0:
        return Ds
    # the (x,y,z) -> (y,z,x) reordering of rows and columns as a roll: an
    # index list would be copied to the device at every call
    D1 = torch.roll(R, shifts=(-1, -1), dims=(-2, -1))
    Ds.append(D1)
    for l in range(2, L + 1):
        C = _const.to_torch(_const.cg_11_blocks(L)[l - 2], R.device, R.dtype)
        # C^T (D^{l-1} (x) D^1) C one operand at a time: a 4-operand
        # torch.einsum searches for a contraction path on the host at every call
        Cf = C.reshape(-1, C.shape[-1])                     # [(2l-1)*3, 2l+1]
        prev = Ds[l - 1]
        n = prev.shape[-1]
        kron = (prev[..., :, None, :, None] * D1[..., None, :, None, :]).reshape(
            *prev.shape[:-2], n * 3, n * 3)
        Ds.append(Cf.T @ kron @ Cf)
    return Ds


def apply_wigner_blocks(Ds, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Apply the block-diagonal Wigner rotation to packed x [..., (L+1)^2]
    (the blocks broadcast against x's leading dims).  A bf16 x meets f32
    blocks at f32, as jnp promotion does in the reference."""
    eq = "...ji,...j->...i" if transpose else "...ij,...j->...i"
    dt = torch.promote_types(Ds[0].dtype, x.dtype)
    x = x.to(dt)
    return torch.cat([torch.einsum(eq, D.to(dt), x[..., l * l: (l + 1) ** 2])
                      for l, D in enumerate(Ds)], dim=-1)


@lru_cache(maxsize=None)
def edge_frame_index(L: int, m_max: int) -> np.ndarray:
    """The packed indices l*l + l + m of the coefficients an edge frame
    keeps, in m-primary order: m = 0 for l = 0..L, then for each m =
    1..m_max the +m coefficients (l = m..L) and the -m ones."""
    out = [l * l + l for l in range(L + 1)]
    for m in range(1, m_max + 1):
        for sign in (1, -1):
            out += [l * l + l + sign * m for l in range(m, L + 1)]
    return np.asarray(out, dtype=np.int64)


@lru_cache(maxsize=None)
def _l_major_to_m_primary(L: int, m_max: int) -> np.ndarray:
    """Row permutation from the l-major order of the |m| <= m_max rows
    (l = 0..L, m ascending) to `edge_frame_index`'s order."""
    l_major = [l * l + l + m for l in range(L + 1)
               for m in range(-min(l, m_max), min(l, m_max) + 1)]
    pos = {k: i for i, k in enumerate(l_major)}
    return np.asarray([pos[int(k)] for k in edge_frame_index(L, m_max)], dtype=np.int64)


def edge_frame_wigner(Ds, m_max: int) -> torch.Tensor:
    """The rows |m| <= m_max of the block-diagonal Wigner rotation with
    blocks ``Ds`` ([D^0, ..., D^L], each [..., 2l+1, 2l+1]) as one matrix
    W [..., n_edge, (L+1)^2], rows in `edge_frame_index` order.
    ``x @ W^T`` takes features x [..., C, (L+1)^2] into the edge frame
    (cut to |m| <= m_max), ``y @ W`` takes them back (the transpose)."""
    L = len(Ds) - 1
    dim = (L + 1) ** 2
    rows = []
    for l, D in enumerate(Ds):
        k = min(l, m_max)
        rows.append(F.pad(D[..., l - k: l + k + 1, :], (l * l, dim - (l + 1) ** 2)))
    perm = _const.to_torch(_l_major_to_m_primary(L, m_max), Ds[0].device)
    return torch.cat(rows, dim=-2).index_select(-2, perm)


@dataclasses.dataclass(frozen=True)
class WignerBlocks:
    """Precomputed rotation-aligned geometry for the eSCN path: the blocks
    [D^0, ..., D^L] of `align_rotation` for a fixed edge geometry, built once
    and reused by every layer of a model stack."""

    blocks: tuple

    @property
    def L(self) -> int:
        return len(self.blocks) - 1

    @classmethod
    def from_rhat(cls, rhat: torch.Tensor, L: int) -> "WignerBlocks":
        return cls(tuple(wigner_blocks_from_rotmat(L, align_rotation(rhat.float()))))


class EquivariantConv:
    """Gaunt equivariant convolution  (x (x) Y(rhat)) with the paper's
    w_{l1} w_{l2} w_l per-degree weights.

    ``method='escn'`` (default): the ``escn_aligned`` backend, built directly
    (`engine.build_escn`).  ``method='general'``: the filter Y(rhat)
    materialized and convolved with x on a pairwise spectral backend,
    'direct' when max(L1, L2) <= 4 and 'fft' above, through a one-item
    `engine.plan_batch` conv_filter bucket (the edge leading dims run as one
    call).  ``method='auto'``: the engine's selection among every
    conv_filter backend.  ``backend`` pins any registered backend.
    ``cdtype`` names the plans' storage (complex64: float32), ``rdtype`` the
    output's dtype.  ``device`` is the plans' device for the general and
    auto methods (None: cuda, raising without a GPU); ``batch_hint`` and
    ``tune`` feed their selection.  ``donate`` is accepted and donates
    nothing.  ``shard_spec`` (`engine.ShardSpec`) runs every call as a
    row-sharded `engine.plan_batch` bucket over the mesh's data-parallel
    ranks, whatever the geometry: raw directions, `WignerBlocks` (a
    Wigner-geometry eSCN bucket) or a resident filter (a Fourier-boundary
    pairwise bucket), as the reference does.

    ``__call__(x, rhat)`` takes raw directions [..., 3], the `WignerBlocks`
    of :meth:`geometry_rep` (eSCN), or the Fourier-resident filter of
    :meth:`filter_rep` (spectral backends); leading dims broadcast between x
    and the geometry.
    """

    def __init__(self, L1: int, L2: int, Lout: int | None = None, method: str = "escn",
                 cdtype=torch.complex64, rdtype=torch.float32,
                 backend: str | None = None, batch_hint: int | None = None,
                 tune: str = "heuristic", donate: bool = False, shard_spec=None,
                 device=None):
        self.L1, self.L2 = L1, L2
        self.Lout = L1 + L2 if Lout is None else Lout
        self.method = method
        self.cdtype, self.rdtype = cdtype, rdtype
        self._dtype = _engine._dtype_str(cdtype)
        if backend is None:
            if method == "escn":
                backend = "escn_aligned"
            elif method == "general":
                backend = _engine.spectral_default(L1, L2)
            elif method != "auto":
                raise ValueError(f"unknown method {method!r}")
        self._bplan = self._plan = None
        self._shard_spec, self._tune = shard_spec, tune
        self._batched: dict = {}
        if backend == "escn_aligned" and shard_spec is None:
            self.backend = backend
            self._raw = build_escn(L1, L2, self.Lout, dtype=self._dtype)
        else:
            self._bplan = _engine.plan_batch(
                [_engine.BatchItem(L1=L1, L2=L2, Lout=self.Lout, size=batch_hint)],
                kind="conv_filter", dtype=self._dtype, backend=backend, tune=tune,
                donate=donate, shard_spec=shard_spec, device=device)
            self._plan = self._bplan.buckets[0].plan
            self.backend = self._plan.backend
            self._raw = None
        self._geom = (build_escn(L1, L2, self.Lout, geometry="wigner", dtype=self._dtype)
                      if self.backend == "escn_aligned" and shard_spec is None else None)
        self._resident_plan = None

    @property
    def plan(self):
        """The conv_filter plan of the general and auto methods (None on the
        directly built eSCN route)."""
        return self._plan

    def _spectral_backend(self) -> str:
        """A Fourier-boundary backend matching this conv's choice."""
        if self.backend in ("fft", "direct", "packed", "rfft"):
            return self.backend
        return _engine.spectral_default(self.L1, self.L2)

    def filter_rep(self, rhat: torch.Tensor, w2=None):
        """Materialize Y(rhat) and convert it to a Fourier-resident Rep once
        per geometry: a half grid when the spectral backend is rfft, else a
        dense one.  Differentiable in rhat, so forces flow through it.
        ``w2`` (per-degree filter weights [..., L2+1]) is folded in here: a
        resident operand takes no per-degree weights downstream."""
        from .gaunt import expand_degree_weights
        from .rep import Rep
        from .so3 import real_sph_harm_torch

        filt = real_sph_harm_torch(self.L2, rhat)
        if w2 is not None:
            filt = filt * expand_degree_weights(w2, self.L2).to(filt.dtype)
        conversion = "half" if self._spectral_backend() == "rfft" else "dense"
        return Rep.from_sh(filt, self.L2).to_fourier(conversion, self.cdtype)

    def geometry_rep(self, rhat: torch.Tensor) -> WignerBlocks:
        """Hoist the alignment rotation and the Wigner recursion out of the
        layer loop: build the blocks once per geometry (eSCN only; the
        general path's counterpart is :meth:`filter_rep`)."""
        if self.backend != "escn_aligned":
            raise ValueError("geometry_rep is the eSCN (rotation-aligned) residency "
                             f"hook; this conv uses {self.backend!r}: use filter_rep "
                             "for the general path")
        return WignerBlocks.from_rhat(rhat, max(self.L1, self.Lout))

    def _sharded(self, kind: str, backend: str, options: tuple, device):
        """The row-sharded one-item bucket of a geometry kind (built once)."""
        key = (kind, backend, options)
        bp = self._batched.get(key)
        if bp is None:
            bp = self._batched[key] = _engine.plan_batch(
                [_engine.BatchItem(L1=self.L1, L2=self.L2, Lout=self.Lout,
                                   options=options)],
                kind=kind, dtype=self._dtype, backend=backend, tune=self._tune,
                shard_spec=self._shard_spec, device=device)
        return bp

    def __call__(self, x, rhat, w1=None, w2=None, w3=None) -> torch.Tensor:
        from .rep import Rep

        if self._shard_spec is not None:
            if isinstance(rhat, WignerBlocks):
                if self.backend != "escn_aligned":
                    raise ValueError("WignerBlocks geometry needs the eSCN backend; "
                                     f"this conv uses {self.backend!r}")
                bp = self._sharded("conv_filter", "escn_aligned",
                                   (("geometry", "wigner"),), x.device)
            elif isinstance(rhat, Rep):
                if w2 is not None:
                    raise ValueError("fold w2 into filter_rep(rhat, w2=...): a resident "
                                     "filter cannot be reweighted")
                bp = self._sharded("pairwise", self._spectral_backend(),
                                   (("boundary", ("sh", "fourier", "sh")),), x.device)
            else:
                bp = self._bplan
            return bp.apply([(x, rhat)], weights=[(w1, w2, w3)])[0].to(self.rdtype)
        if isinstance(rhat, WignerBlocks):
            if self._geom is None:
                raise ValueError("WignerBlocks geometry needs the eSCN backend; this "
                                 f"conv uses {self.backend!r}")
            return self._geom(x, rhat, w1, w2, w3).to(self.rdtype)
        if isinstance(rhat, Rep):
            if w2 is not None:
                raise ValueError("fold w2 into filter_rep(rhat, w2=...): a resident "
                                 "filter cannot be reweighted")
            if self._resident_plan is None:
                self._resident_plan = _engine.plan(
                    self.L1, self.L2, self.Lout, kind="pairwise",
                    backend=self._spectral_backend(), dtype=self._dtype,
                    options={"boundary": ("sh", "fourier", "sh")},
                    device=rhat.data.device)
            return self._resident_plan.apply(x, rhat, w1, None, w3).to(self.rdtype)
        if self._raw is not None:
            return self._raw(x, rhat, w1, w2, w3).to(self.rdtype)
        return self._bplan.apply([(x, rhat)], weights=[(w1, w2, w3)])[0].to(self.rdtype)
