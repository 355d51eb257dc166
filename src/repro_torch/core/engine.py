"""The Gaunt engine, main-path subset: chain plans, the measured chain
autotuner, the eSCN conv backend and the affine-gate helpers.

Chain backends (`CHAIN_BACKENDS`):

* ``tree`` — the resident spectral pass: each distinct operand converts to
  a Hermitian half grid once (degree-resolved when the same tensor enters
  under different per-degree weights), grids combine by a divide-and-conquer
  tree of `conv2d_herm` (rfft), and one projection runs at the exit.
* ``fused_torch`` — the n-way collocation product in plain torch ops (the
  reference's ``fused_xla``).
* ``fused_hopper`` — the same product on the hand-written sm_90a kernel
  (`kernels.gaunt_fused.gaunt_chain_fused_hopper`; the reference's
  ``fused_pallas``).

``plan_chain(tune='measure')`` times the candidates on the caller's device
— ``tree`` and ``fused_hopper`` on CUDA, ``tree`` and ``fused_torch`` on the
CPU — and caches the winner per (chain shape, rows, gate, device).  A
candidate that raises is not skipped: a kernel that fails to build or
launch must surface, not quietly lose the measurement.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import constants
from .gaunt import expand_degree_weights
from .irreps import num_coeffs

__all__ = [
    "CHAIN_BACKENDS",
    "ChainPlan",
    "GauntEngine",
    "build_escn",
    "get_engine",
    "plan_chain",
]

CHAIN_BACKENDS = ("tree", "fused_torch", "fused_hopper")

_RDTYPE = {"float32": torch.float32, "float64": torch.float64}
_CDTYPE = {"float32": torch.complex64, "float64": torch.complex128}


def _dtype_str(dtype) -> str:
    s = dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")
    if s == "bfloat16":
        raise NotImplementedError("bfloat16 storage is not ported yet")
    if s not in _RDTYPE:
        raise ValueError(f"unsupported dtype {s!r} (expected one of {sorted(_RDTYPE)})")
    return s


def _wmul(x, w, L: int):
    return x if w is None else x * expand_degree_weights(w, L).to(x.dtype)


def _chain_entry_cast(x, rd):
    """The chain-entry dtype rule: an SH operand in another dtype than the
    plan's is cast once, at entry."""
    return x if x.dtype == rd else x.to(rd)


# --------------------------------------------------------------------------
# the affine gate — models.gate_apply, given its l=0 scalars
# --------------------------------------------------------------------------

# Y_00 = 1/(2 sqrt(pi)): one unit of SH coefficient 0 is this constant on S^2
_GATE_C0 = 0.5 / math.sqrt(math.pi)


def _gate_mlp(p, s):
    """The gate's scalar MLP: l=0 scalars s [..., C] -> gate g [..., C]."""
    return torch.sigmoid(F.silu(s @ p["w1"]) @ p["w2"])


def _gate_coeffs(p, s):
    """(g, beta): the gate in affine form, gate(x) = g*x + beta*e0 on packed
    SH (g*f + beta*Y00 on sphere samples), beta = silu(s) - g*s.  Affine in
    the signal, so it commutes with the projection and fuses into the
    collocation kernel as a per-row scale and shift."""
    g = _gate_mlp(p, s)
    return g, F.silu(s) - g * s


def _gate_sh(p, x):
    """Apply the gate on packed SH coefficients (== models.gate_apply)."""
    s = x[..., 0]
    g = _gate_mlp(p, s)
    return torch.cat([F.silu(s)[..., None], x[..., 1:] * g[..., None]], dim=-1)


def _gate_rep(p, rep):
    """Apply the gate on a half-grid resident Rep without leaving the basis:
    the l=0 scalars come from the z-transform's l0 row, the grid scales by
    g and beta*Y00 lands on the (u, v) = (0, 0) mode."""
    from .rep import Rep

    Fh, L = rep.data, rep.L
    z0 = constants.to_torch(constants.z_half_l0(L, str(Fh.dtype)[6:]), Fh.device)
    s = torch.einsum("...uv,uv->...", Fh, z0).real
    g, beta = _gate_coeffs(p, s)
    Fh = Fh * g[..., None, None].to(Fh.dtype)
    bump = torch.zeros_like(Fh)
    bump[..., L, 0] = (beta * _GATE_C0).to(Fh.dtype)
    return Rep(Fh + bump, L, "fourier", "half")


# --------------------------------------------------------------------------
# chain plans
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A chained Gaunt product  x_1 (x) x_2 (x) ... (x) x_n  on one backend.

    ``apply(xs, weights=None, w_out=None, out_basis='sh', gate_params=None)``:
      xs      : per-operand SH tensors or Fourier-resident Reps
      weights : per-operand per-degree weights [..., L_i+1] (None entries ok)
      w_out   : per-degree output weights, applied after the exit (and gate)
      out_basis: 'sh' projects to degrees <= Lout; 'fourier' returns the
                resident half product grid as a Rep (Lout == sum(Ls))
      gate_params: {'w1', 'w2'} of the gate MLP — required iff ``gate``
    """

    Ls: tuple
    Lout: int
    dtype: str
    backend: str
    gate: bool
    _apply: Callable = dataclasses.field(repr=False, compare=False)

    def apply(self, xs, weights=None, w_out=None, out_basis: str = "sh",
              gate_params=None):
        if self.gate and gate_params is None:
            raise ValueError("this chain plan was built with gate=True; apply "
                             "needs gate_params={'w1', 'w2'}")
        if gate_params is not None and not self.gate:
            raise ValueError("gate_params passed to an ungated chain plan — "
                             "build it with plan_chain(..., gate=True)")
        if out_basis not in ("sh", "fourier"):
            raise ValueError(f"out_basis must be 'sh'|'fourier', got {out_basis!r}")
        xs = list(xs)
        if len(xs) != len(self.Ls):
            raise ValueError(f"chain got {len(xs)} operands for degrees {self.Ls}")
        ws = list(weights) if weights is not None else [None] * len(xs)
        if len(ws) != len(xs):
            raise ValueError(f"chain got {len(ws)} weight entries for "
                             f"{len(xs)} operands")
        if out_basis == "fourier":
            if w_out is not None:
                raise ValueError("w_out applies in SH; project first")
            if self.Lout != sum(self.Ls):
                raise ValueError(f"out_basis='fourier' keeps the full grid "
                                 f"(L={sum(self.Ls)}); plan with Lout={sum(self.Ls)}")
        return self._apply(xs, ws, w_out, out_basis, gate_params)


def _build_chain(Ls: tuple, Lout: int, dtype: str) -> Callable:
    """The tree backend: convert each distinct operand once, combine the
    half grids, project once."""
    from .gaunt import fourier_to_sh, sh_to_fourier, sh_to_fourier_bydeg
    from .manybody import _tree_convolve
    from .rep import Rep

    rd, cd = _RDTYPE[dtype], _CDTYPE[dtype]
    Ltot = sum(Ls)

    def apply(xs, ws, w_out, out_basis, gate_params):
        grids: list = [None] * len(xs)
        groups: dict[int, list[int]] = {}
        for i, x in enumerate(xs):
            if isinstance(x, Rep):
                if x.is_fourier:
                    if x.L != Ls[i]:
                        raise ValueError(f"operand {i}: resident bandlimit {x.L} "
                                         f"!= planned degree {Ls[i]}")
                    if ws[i] is not None:
                        raise ValueError("resident operands cannot take "
                                         "per-degree weights (apply in SH)")
                    grids[i] = x.with_form("half").data
                    continue
                xs[i] = x.data
            groups.setdefault(id(xs[i]), []).append(i)
        for idxs in groups.values():
            x, L = _chain_entry_cast(xs[idxs[0]], rd), Ls[idxs[0]]
            if len(idxs) == 1 or len({id(ws[i]) for i in idxs}) == 1:
                Fg = sh_to_fourier(_wmul(x, ws[idxs[0]], L), L, "half", cd)
                for i in idxs:
                    grids[i] = Fg
            else:
                # shared operand, different weights: one degree-resolved
                # conversion plus a cheap per-copy degree combination
                Fl = sh_to_fourier_bydeg(x, L, "half", cd)
                for i in idxs:
                    grids[i] = (Fl.sum(-3) if ws[i] is None else
                                torch.einsum("...l,...luv->...uv", ws[i].to(Fl.dtype), Fl))
        Fp = _tree_convolve(grids)
        if out_basis == "fourier":
            return Rep(Fp, Ltot, "fourier", "half")
        return _wmul(fourier_to_sh(Fp, Ltot, Lout, "half", rd), w_out, Lout)

    return apply


def _wrap_chain_gate(base: Callable, Lout: int) -> Callable:
    """Gate the tree backend at its exit: on the packed SH coefficients
    (before ``w_out``) or on the resident grid for a 'fourier' exit."""

    def apply(xs, ws, w_out, out_basis, gate_params):
        out = base(xs, ws, None, out_basis, None)
        if out_basis == "fourier":
            return _gate_rep(gate_params, out)
        return _wmul(_gate_sh(gate_params, out).to(out.dtype), w_out, Lout)

    return apply


def _build_chain_fused(Ls: tuple, Lout: int, dtype: str, kernel: bool,
                       gate: bool) -> Callable:
    """The n-way collocation chain: sample every operand onto the shared
    alias-free product grid, multiply pointwise n-way, project once — one
    kernel launch on ``fused_hopper``.  With ``gate`` the product's l=0
    scalars come from the multilinear form `constants.chain_l0` (the kernel
    cannot feed its own output to the gate MLP), the MLP turns them into
    per-row (g, beta*Y00) outside the kernel, and the kernel applies
    ``v <- v*g + beta*Y00`` to the product samples before projection."""
    from ..kernels.gaunt_fused import (gaunt_chain_fused_hopper,
                                       gaunt_chain_fused_torch)
    from .rep import Rep

    rd = _RDTYPE[dtype]
    Ltot = sum(Ls)
    constants.chain_matrices(tuple(Ls), Lout, ("sh",) * len(Ls), "sh",
                             pad_lanes=False, dtype=dtype)
    if gate:
        constants.chain_l0(tuple(Ls), ("sh",) * len(Ls))
    fn = gaunt_chain_fused_hopper if kernel else gaunt_chain_fused_torch

    def apply(xs, ws, w_out, out_basis, gate_params):
        entries, arrs = [], []
        for i, x in enumerate(xs):
            if isinstance(x, Rep) and x.is_fourier:
                if x.L != Ls[i]:
                    raise ValueError(f"operand {i}: resident bandlimit {x.L} "
                                     f"!= planned degree {Ls[i]}")
                if ws[i] is not None:
                    raise ValueError("resident operands cannot take per-degree "
                                     "weights (apply in SH)")
                entries.append("grid")
                arrs.append(x.with_form("half").data)
            else:
                if isinstance(x, Rep):
                    x = x.data
                entries.append("sh")
                arrs.append(_wmul(_chain_entry_cast(x, rd), ws[i], Ls[i]))
        gate_arg = None
        if gate:
            flat = []
            for a, e in zip(arrs, entries):
                if e == "grid":
                    Fl = a.reshape(*a.shape[:-2], -1)
                    a = torch.cat([Fl.real, Fl.imag], dim=-1)
                flat.append(a.to(rd))
            M = constants.to_torch(constants.chain_l0(tuple(Ls), tuple(entries)),
                                   flat[0].device, rd)
            # s = einsum('...a,...b,...,ab...->...', *flat, M), contracted one
            # operand at a time: a multi-operand torch.einsum searches for a
            # contraction path on the host at every call
            t = flat[0] @ M.reshape(M.shape[0], -1)
            for a in flat[1:]:
                t = (a[..., :, None] * t.reshape(*t.shape[:-1], a.shape[-1], -1)).sum(-2)
            g, beta = _gate_coeffs(gate_params, t[..., 0])
            gate_arg = (g, beta * _GATE_C0)
        out = fn(arrs, Ls, Lout, entries=tuple(entries),
                 out_entry="grid" if out_basis == "fourier" else "sh",
                 dtype=dtype, gate=gate_arg)
        if out_basis == "fourier":
            return Rep(out, Ltot, "fourier", "half")
        return _wmul(out.to(rd), w_out, Lout)

    return apply


# --------------------------------------------------------------------------
# the eSCN (rotation-aligned) conv backend
# --------------------------------------------------------------------------


def build_escn(L1: int, L2: int, Lout: int, geometry: str | None = None,
               dtype: str = "float32") -> Callable:
    """The ``escn_aligned`` conv_filter backend: rotate x so the edge lies
    on the zenith, where the SH filter has only m = 0 components and its
    torus grid is the single v = 0 column; the 2D convolution becomes a
    banded 1D convolution along u; rotate back.  ``geometry='wigner'``
    takes precomputed `conv.WignerBlocks` instead of raw directions."""
    cd, rd = _CDTYPE[dtype], _RDTYPE[dtype]
    cname = str(cd)[6:]
    fl0 = np.array([math.sqrt((2 * l + 1) / (4 * math.pi)) for l in range(L2 + 1)],
                   dtype=np.float32)
    gidx, mask = constants.conv_u_index(L1, L2)
    pv = L2  # the v support stays |v| <= L1 inside the (2(L1+L2)+1)-wide grid

    def apply_conv(x, rhat, w1=None, w2=None, w3=None):
        from .conv import (WignerBlocks, align_rotation, apply_wigner_blocks,
                           wigner_blocks_from_rotmat)
        from .gaunt import fourier_to_sh, sh_to_fourier

        dev = x.device
        x = _wmul(x, w1, L1)
        if geometry == "wigner":
            if not isinstance(rhat, WignerBlocks):
                raise ValueError("geometry='wigner' takes precomputed WignerBlocks "
                                 f"(EquivariantConv.geometry_rep), got {type(rhat).__name__}")
            if rhat.L < max(L1, Lout):
                raise ValueError(f"WignerBlocks cover degrees <= {rhat.L}, "
                                 f"need max(L1, Lout) = {max(L1, Lout)}")
            Ds = list(rhat.blocks)
        else:
            Ds = wigner_blocks_from_rotmat(max(L1, Lout), align_rotation(rhat.to(rd)))
        F1 = sh_to_fourier(apply_wigner_blocks(Ds[: L1 + 1], x), L1, "dense", cd)
        fl = constants.to_torch(fl0, dev, rd)
        if w2 is not None:
            fl = fl * w2.to(rd)
        cols = constants.to_torch(constants.filter_fourier_col(L2, cname), dev)
        k = torch.einsum("...l,lu->...u", fl.to(cols.dtype), cols)
        kmat = k[..., constants.to_torch(gidx, dev, torch.int64)] \
            * constants.to_torch(mask, dev, rd)
        F3 = torch.einsum("...ti,...iv->...tv", kmat, F1)
        z = F3.new_zeros(F3.shape[:-1] + (pv,))
        F3 = torch.cat([z, F3, z], dim=-1)
        out_rot = fourier_to_sh(F3, L1 + L2, Lout, "dense", rd)
        out = apply_wigner_blocks(Ds[: Lout + 1], out_rot, transpose=True)
        return _wmul(out, w3, Lout)

    return apply_conv


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class GauntEngine:
    """Caches chain plans and the measured chain-backend selections."""

    def __init__(self):
        self._chains: dict = {}
        self._measured: dict = {}
        self.measured_times: dict = {}   # key -> {backend: median seconds}
        self.measured_spread: dict = {}  # key -> {backend: (min, max) seconds}
        self.timing_runs = 0

    def plan_chain(self, Ls, Lout: int | None = None, *, dtype="float32",
                   backend: str | None = None, tune: str = "heuristic",
                   batch_hint: int | None = None, share_hint: tuple | None = None,
                   gate: bool = False, device=None) -> ChainPlan:
        """Plan  x_1 (x) ... (x) x_n  (n >= 2, Lout defaults to sum(Ls)).

        ``backend`` pins one of `CHAIN_BACKENDS`; otherwise ``tune='measure'``
        times the device's candidates at ``batch_hint`` rows (``share_hint``:
        per-operand duplicate-group indices, so a shared operand is measured
        as shared) on ``device`` (default cuda), and ``tune='heuristic'``
        picks 'tree'.
        ``gate=True`` plans the models' gate as a chain-interior stage.
        """
        Ls = tuple(int(L) for L in Ls)
        if len(Ls) < 2:
            raise ValueError("chain plans need at least 2 operands")
        Lout = sum(Ls) if Lout is None else int(Lout)
        if Lout > sum(Ls):
            raise ValueError("Lout cannot exceed the total degree (Gaunt selection rule)")
        dts = _dtype_str(dtype)
        if backend is not None and backend not in CHAIN_BACKENDS:
            raise ValueError(f"unknown chain backend {backend!r} "
                             f"(expected one of {CHAIN_BACKENDS})")
        if backend is None:
            if tune == "measure":
                backend = self._select_chain(Ls, Lout, dts, batch_hint, share_hint,
                                             gate, resolve_device(device))
            elif tune == "heuristic":
                backend = "tree"
            else:
                raise ValueError(f"unknown tune {tune!r} (expected 'heuristic'|'measure')")
        key = (Ls, Lout, dts, backend, gate)
        hit = self._chains.get(key)
        if hit is not None:
            return hit
        if backend == "tree":
            apply = _build_chain(Ls, Lout, dts)
            if gate:
                apply = _wrap_chain_gate(apply, Lout)
        else:
            apply = _build_chain_fused(Ls, Lout, dts, kernel=backend == "fused_hopper",
                                       gate=gate)
        cp = self._chains[key] = ChainPlan(Ls, Lout, dts, backend, gate, apply)
        return cp

    @staticmethod
    def chain_measure_key(Ls: tuple, Lout: int, dts: str, batch_hint: int | None,
                          share_hint: tuple | None, gate: bool, device) -> tuple:
        """The measured-selection key: rows quantize to a power-of-two ladder
        capped at 16384, as in the reference."""
        if batch_hint is not None:
            q = 8
            while q < min(batch_hint, 16384):
                q *= 2
            batch_hint = q
        share = tuple(share_hint) if share_hint else tuple(range(len(Ls)))
        return (Ls, Lout, dts, batch_hint, share, bool(gate), torch.device(device).type)

    def _select_chain(self, Ls, Lout, dts, batch_hint, share_hint, gate, device) -> str:
        key = self.chain_measure_key(Ls, Lout, dts, batch_hint, share_hint, gate, device)
        hit = self._measured.get(key)
        if hit is not None:
            return hit
        self.timing_runs += 1
        kernel = "fused_hopper" if device.type == "cuda" else "fused_torch"
        B, share = key[3] or 256, key[4]
        rng = np.random.default_rng(0)
        rd = _RDTYPE[dts]
        made: dict = {}
        xs = []
        for L, g in zip(Ls, share):
            if (g, L) not in made:
                made[(g, L)] = torch.as_tensor(rng.normal(size=(B, num_coeffs(L))),
                                               dtype=rd, device=device)
            xs.append(made[(g, L)])
        # synthetic gate MLP sized so the per-row scalar path costs what the
        # models' [rows, C] @ [C, hidden] gate head costs (as the reference)
        gp = ({"w1": torch.as_tensor(rng.normal(size=(B, 16)), dtype=rd, device=device),
               "w2": torch.as_tensor(rng.normal(size=(16, B)), dtype=rd, device=device)}
              if gate else None)
        times, spread = {}, {}
        with torch.no_grad():
            for name in ("tree", kernel):
                cp = self.plan_chain(Ls, Lout, dtype=dts, backend=name, gate=gate)
                ts = _time_calls(lambda: cp.apply(xs, gate_params=gp), device)
                times[name] = float(np.median(ts))
                spread[name] = (min(ts), max(ts))
        best = min(times, key=times.get)
        self._measured[key] = best
        self.measured_times[key] = times
        self.measured_spread[key] = spread
        return best


_MEASURE_REPS = 20


def _time_calls(fn, device, reps: int = _MEASURE_REPS) -> list[float]:
    """Seconds per call of ``fn`` over ``reps`` calls after two warm calls
    (the first builds and launches).  On CUDA each call runs between two
    events on an idle stream, so the time holds the host's launches and the
    device's work; on the CPU it is the host clock."""
    cuda = device.type == "cuda"
    for _ in range(2):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return ts


_ENGINE = GauntEngine()


def get_engine() -> GauntEngine:
    """The process-wide engine (plans and measurements are cached on it)."""
    return _ENGINE


def plan_chain(*args, **kw) -> ChainPlan:
    return _ENGINE.plan_chain(*args, **kw)
