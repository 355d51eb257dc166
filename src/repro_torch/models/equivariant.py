"""The paper's model family on the Gaunt ops, in PyTorch: the MACE-like
force field, the SEGNN-like N-body net and the EquiformerV2 Selfmix layer.

MaceGaunt.  Each layer: an equivariant convolution of neighbour features
against the edge geometry (messages summed over neighbours within the
cutoff) — ``conv_impl='escn'``, the rotation-aligned path, or 'general',
the paper's own: the filter Y(r_hat) on its Fourier grid, convolved in 2D
with each neighbour's grid — a degree-wise channel mix with a residual, the nu-fold
many-body self-product (one chain plan — on the collocation kernel when
``chain_tune='measure'`` picks it), a second channel mix and the
equivariant gate.  ``compute_dtype='bfloat16'`` stores the many-body chain
at bf16 (entry cast, bf16 exit), as in the reference; the conv, the mixes
and the gate stay f32, the mixes promoting the bf16 exit.  Energy is a sum
of per-atom readouts of the invariant channels; forces are -dE/dpos by
autograd, and the training loss (`MaceGaunt.loss`) differentiates them
once more.

SegnnNBody (the paper's Fig. 1(e) sanity check).  Steerable message
passing over the fully connected particles: each message is the tensor
product of the neighbour's features with the edge's SH filter, under
per-edge per-degree radial weights.  With the resident route the edge
filter converts to the Fourier basis once for the whole layer stack and
each layer's product is a 2-operand chain plan with a Fourier entry (on
the chain kernel when the measured pick is ``fused_hopper``); ``tp_impl``
'cg' is the Clebsch-Gordan baseline.  ``grid_gate='on'`` evaluates the gate
on the S^2 quadrature grid (`_gate_quad`, the same function).

SelfmixLayer (the paper's Table 1 Equivariant Feature Interaction):
x -> x + mix(GauntTP(w1 . x, w2 . x)), a shared-operand chain with
per-operand weights (one degree-resolved conversion serves both on the
tree route).

Layouts match the reference: features x [..., n, C, (L+1)^2], positions
[..., n, 3].  MaceGaunt and SegnnNBody also take a leading batch of systems
(molecules, N-body systems) and evaluate them in one pass: the systems
never interact, so this equals the reference's vmap.  A stated deviation
follows: a measured chain key counts the whole batch's rows, as the serve
buckets' keys do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.gaunt_ff import EquivariantConfig
from ..core import engine as _engine
from ..core.cg import cg_full_tensor_product
from ..core.constants import to_torch
from ..core.conv import EquivariantConv, axis_vector
from ..core.engine import _GATE_C0, _gate_coeffs, _gate_sh
from ..core.gaunt import expand_degree_weights
from ..core.irreps import l_array, num_coeffs
from ..core.manybody import manybody_selfmix
from ..core.rep import Rep
from ..core.so3 import real_sph_harm_torch
from ..device import resolve_device
from ..distributed.sharding import get_activation_mesh
from ..spans import span

__all__ = ["MaceGaunt", "SegnnNBody", "SelfmixLayer", "equi_linear", "equi_linear_init",
           "gate_init", "gate_apply", "radial_basis"]


def equi_linear_init(generator: torch.Generator, L: int, c_in: int, c_out: int) -> torch.Tensor:
    """A degree-wise channel mix [L+1, c_in, c_out] ~ N(0, 1/c_in), drawn
    from ``generator`` on its device."""
    return torch.randn((L + 1, c_in, c_out), generator=generator,
                       device=generator.device) / math.sqrt(c_in)


def gate_init(generator: torch.Generator, c: int, hidden: int = 32) -> dict:
    """The gate's scalar MLP {w1 [c, hidden], w2 [hidden, c]}, drawn from
    ``generator`` on its device (the reference's gate layout)."""
    dev = generator.device
    return {"w1": torch.randn((c, hidden), generator=generator, device=dev) / math.sqrt(c),
            "w2": torch.randn((hidden, c), generator=generator, device=dev)
            / math.sqrt(hidden)}


def gate_apply(p: dict, x: torch.Tensor, L: int) -> torch.Tensor:
    """Scalars gate higher degrees (the equivariant nonlinearity): x [..., C,
    (L+1)^2] -> [silu(s), x_{l>0} * sigmoid(silu(s w1) w2)] with s the l=0
    channel scalars, at the promoted dtype of x and the weights."""
    return _gate_sh(p, x)


def equi_linear(w: torch.Tensor, x: torch.Tensor, L: int) -> torch.Tensor:
    """Degree-wise channel mixing: x [..., C, (L+1)^2] @ w [L+1, C, C'], at
    the promoted dtype of the two (a bf16 chain exit against f32 weights
    mixes in f32, as ``jnp.einsum`` promotes in the reference)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    wl = w[to_torch(l_array(L), w.device, torch.int64)]
    return torch.einsum("...ck,kcd->...dk", x.to(dt), wl.to(dt))


def _gate_quad(p, x: torch.Tensor, L: int, os: int = 2) -> torch.Tensor:
    """The gate evaluated on the S^2 quadrature grid.  Once its l=0 scalars
    are known the gate is affine in the signal (f -> g f + beta Y00), so
    the grid evaluation is exact at any quadrature order and equals the SH
    gate; it ticks the sh_to_quad / quad_to_sh counters (SEGNN's post-mix
    gate, where no chain is adjacent to absorb it)."""
    s = x[..., 0]
    g, beta = _gate_coeffs(p, s.to(torch.promote_types(s.dtype, p["w1"].dtype)))
    rep = Rep.from_sh(x, L).to_quad(os=os)
    gated = rep.apply_pointwise(
        lambda v: v * g[..., None, None].to(v.dtype)
        + (beta * _GATE_C0)[..., None, None].to(v.dtype))
    return gated.to_sh(L).data.to(x.dtype)


class _Picks(nn.Module):
    """A model whose 'auto' options (``grid_gate``, ``compute_dtype``) are
    measured decisions that change the function it computes.  Each is
    resolved once, the first time it is asked for, and kept in the model's
    state: an int8 buffer per decision (-1 while unresolved, else the
    index of the choice), so ``state_dict``, ``load_state_dict`` and
    checkpoints carry it, and a reloaded model evaluates the function it
    was trained or served with without timing anything again.  A state
    without them (the reference's converted parameters, `models.convert`:
    the reference stores no such decision) loads and leaves them as they
    were.  A host copy of each resolved buffer is what a step reads,
    so a step, captured in a CUDA graph or not, never reads the device."""

    _PICKS: dict = {}  # buffer name -> its choices

    def _init_picks(self, device) -> None:
        self._resolved: dict = {}
        for name in self._PICKS:
            self.register_buffer(name, torch.tensor(-1, dtype=torch.int8, device=device))

    def _pick(self, name: str, resolve):
        """The stored decision ``name``; ``resolve()`` only when none is."""
        if name not in self._resolved:
            buf, choices = getattr(self, name), self._PICKS[name]
            code = int(buf)
            if code < 0:
                code = choices.index(resolve())
                buf.fill_(code)
            self._resolved[name] = choices[code]
        return self._resolved[name]

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)
        self._resolved.clear()
        for name in self._PICKS:
            if prefix + name in missing_keys:
                missing_keys.remove(prefix + name)


def _model_dtype(cfg) -> str:
    """The config's Gaunt storage dtype ('float32' when absent)."""
    return getattr(cfg, "compute_dtype", "float32")


def _resolve_grid_gate(cfg, Ls=None, Lout=None, batch_hint=None, share_hint=None,
                       device=None, dtype=None) -> bool:
    """``cfg.grid_gate`` as on/off for one gated chain workload.  'auto'
    asks the engine's measured gate policy (`GauntEngine.select_gate`,
    keyed like the chain, at ``dtype``, by default the config's) and needs
    chain_tune='measure'; otherwise it is off.  For MACE the grid gate is a
    parameterization (gate before mb_mix): a model resolves 'auto' once and
    keeps it in its state (`MaceGaunt.grid_gate_on`)."""
    mode = getattr(cfg, "grid_gate", "off")
    if mode in ("off", None, False):
        return False
    if mode in ("on", "grid", True):
        return True
    if mode != "auto":
        raise ValueError(f"unknown grid_gate {mode!r}")
    if getattr(cfg, "chain_tune", "heuristic") != "measure":
        return False
    return _engine.get_engine().select_gate(
        Ls, Lout, dtype=dtype or _model_dtype(cfg), batch_hint=batch_hint,
        entry_hint=("sh",) * len(Ls), share_hint=share_hint, device=device) == "grid"


def radial_basis(r: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Bessel-like radial basis with a smooth cutoff envelope. r [...]."""
    rs = r.clamp_min(1e-4)
    k = torch.arange(1, n + 1, device=r.device, dtype=r.dtype) * math.pi / cutoff
    rb = torch.sin(k * rs[..., None]) / rs[..., None]
    env = torch.where(r < cutoff, 0.5 * (torch.cos(math.pi * r / cutoff) + 1.0),
                      torch.zeros_like(r))
    return rb * env[..., None]


def _pair_geometry(pos: torch.Tensor, cutoff: float):
    """Dense pairwise edges with cutoff mask.  pos [..., n, 3].

    The diagonal gets ``+ eye`` inside the norm and masked pairs a *unit*
    placeholder direction: the gradient of a norm at zero and the alignment
    rotation of a zero vector are NaN, and NaN * mask is still NaN — the
    masking has to happen before the math, not after.
    """
    n = pos.shape[-2]
    eye = torch.eye(n, device=pos.device, dtype=pos.dtype)
    diff = pos[..., None, :, :] - pos[..., :, None, :]  # r_ij = r_j - r_i
    dist = torch.linalg.norm(diff + eye[..., None], dim=-1) * (1 - eye)
    mask = (dist > 1e-6) & (dist < cutoff)
    rhat = diff / dist[..., None].clamp_min(1e-6)
    ez = axis_vector(2, pos).expand_as(rhat)
    rhat = torch.where(mask[..., None], rhat, ez)
    return rhat, dist, mask


# tp_impl -> engine backend: 'gaunt' the spectral default for the degrees,
# 'gaunt_fused' the collocation product in torch ops (the reference's
# 'fused_xla'), 'gaunt_auto' the engine's pick; any other impl is CG
_TP_BACKEND = {"gaunt": None, "gaunt_fused": "fused_torch", "gaunt_auto": "auto"}


def _resolve_tp_backend(impl: str, L1: int, L2: int):
    """A tp_impl name -> an engine backend name (None: the engine picks)."""
    if impl == "gaunt":
        return _engine.spectral_default(L1, L2)
    backend = _TP_BACKEND[impl]
    return None if backend == "auto" else backend


def _cast_sd(x: torch.Tensor, dts: str) -> torch.Tensor:
    """Cast an SH operand to the model's resolved storage dtype at the
    product boundary (the model-side mirror of the chain-entry cast)."""
    dt = _engine._RDTYPE[dts]
    return x if x.dtype == dt else x.to(dt)


def _shard(cfg: EquivariantConfig):
    """The row layout of a ``shard_data`` config: the activation mesh's
    data-parallel axes (None: unsharded)."""
    return _engine.ShardSpec() if cfg.shard_data else None


def _tp(cfg: EquivariantConfig, L1: int, L2: int, Lout: int, device, dts: str):
    """The configured tensor product at storage ``dts`` as a batched engine
    plan (one bucket: the edge x channel leading dims run as one call; its
    rows split over the data-parallel ranks with ``shard_data``), or the CG
    baseline."""
    if cfg.tp_impl in _TP_BACKEND:
        bp = _engine.plan_batch([(L1, L2, Lout)], kind="pairwise",
                                backend=_resolve_tp_backend(cfg.tp_impl, L1, L2),
                                dtype=dts, shard_spec=_shard(cfg), device=device)
        return lambda a, b: bp.apply([(_cast_sd(a, dts), _cast_sd(b, dts))])[0]
    return lambda a, b: cg_full_tensor_product(a, b, L1, L2, Lout)


def _tp_resident(cfg: EquivariantConfig, L1: int, L2: int, Lout: int, device, dts: str):
    """A Fourier-resident tensor product at storage ``dts`` for a
    layer-constant second operand, or None when the config cannot use one.

    Returns (to_rep, tp): ``to_rep(filt)`` converts the SH filter to a
    resident Rep once; ``tp(x, rep)`` runs the product with the filter's
    conversion elided, so a stack of n layers pays 1 filter conversion
    instead of n.  The product is a 2-operand chain plan with a Fourier
    entry, so ``chain_tune='measure'`` may run it on the collocation kernel
    (the resident filter then enters as a grid).  With ``shard_data`` the
    same boundary contract runs as a row-sharded Fourier-boundary pairwise
    bucket (resident grids split like SH rows), as in the reference."""
    if cfg.tp_impl not in ("gaunt", "gaunt_auto") or not getattr(cfg, "fourier_resident", True):
        return None
    tune = getattr(cfg, "chain_tune", "heuristic")

    def to_rep(filt):
        return Rep.from_sh(filt, L2).to_fourier("dense")

    if cfg.shard_data:
        bp = _engine.plan_batch(
            [_engine.BatchItem(L1=L1, L2=L2, Lout=Lout,
                               options=(("boundary", ("sh", "fourier", "sh")),))],
            kind="pairwise", backend=_resolve_tp_backend("gaunt", L1, L2), dtype=dts,
            shard_spec=_shard(cfg), device=device)
        return to_rep, (lambda a, rep: bp.apply([(_cast_sd(a, dts), rep)])[0])

    def tp(a, rep):
        # planned per call so 'measure' keys on the real row count (a
        # cached lookup after the first call)
        hint = int(np.prod(a.shape[:-1])) if tune == "measure" else None
        cp = _engine.plan_chain((L1, L2), Lout, tune=tune, batch_hint=hint,
                                entry_hint=("sh", "fourier"), dtype=dts, device=device)
        return cp.apply([a, rep])

    return to_rep, tp


class MaceLayer(nn.Module):
    """One interaction layer's parameters."""

    def __init__(self, c: EquivariantConfig, device):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.radial_w1 = p(c.n_radial, 32)
        self.radial_w2 = p(32, c.channels * (c.L + 1))
        self.mix = p(c.L + 1, c.channels, c.channels)
        self.mb_mix = p(c.L + 1, c.channels, c.channels)
        self.mb_w = p(c.nu, c.L + 1)
        self.gate_w1 = p(c.channels, 32)
        self.gate_w2 = p(32, c.channels)

    def gate(self) -> dict:
        return {"w1": self.gate_w1, "w2": self.gate_w2}


class MaceGaunt(_Picks):
    """MACE-like force field.  ``device=None`` means CUDA (raises without a
    GPU); pass ``device='cpu'`` for the plain path.  Parameters come from
    ``init(generator)`` (random, seeded) or, for parity with the reference,
    from `models.convert.params_from_jax` via ``load_state_dict``.  The
    'auto' grid gate and storage dtype are resolved once and kept in the
    state (`_Picks`)."""

    _PICKS = {"grid_gate_pick": (False, True), "dtype_pick": ("float32", "bfloat16")}

    def __init__(self, cfg: EquivariantConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        c, dev = cfg, self.device
        self.species = nn.Parameter(torch.empty(c.n_species, c.channels, device=dev))
        self.readout_w1 = nn.Parameter(torch.empty(c.channels, c.hidden, device=dev))
        self.readout_w2 = nn.Parameter(torch.empty(c.hidden, 1, device=dev))
        self.layers = nn.ModuleList(MaceLayer(c, dev) for _ in range(c.n_layers))
        self.conv = EquivariantConv(c.L, c.L_edge, c.L, method=c.conv_impl, device=dev)
        self._sharded_conv = (None, None)  # (activation mesh, its conv) of shard_data
        self._init_picks(dev)
        self.init(generator if generator is not None else torch.Generator().manual_seed(0))

    def conv_for(self, device) -> EquivariantConv:
        """The conv of a call: with ``shard_data``, one whose rows split over
        the activation mesh registered now, built once per mesh (its plans
        and buckets are its own, so a conv built per call would plan anew
        every call)."""
        if not self.cfg.shard_data:
            return self.conv
        mesh = get_activation_mesh()
        if self._sharded_conv[0] is not mesh or self._sharded_conv[1] is None:
            c = self.cfg
            self._sharded_conv = (mesh, EquivariantConv(
                c.L, c.L_edge, c.L, method=c.conv_impl,
                shard_spec=_engine.ShardSpec(mesh), device=device))
        return self._sharded_conv[1]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Random parameters with the reference's scales (a CPU generator, so
        the same seed gives the same weights on every device)."""
        c = self.cfg

        def normal(t, scale):
            t.copy_(torch.randn(t.shape, generator=generator) * scale)

        normal(self.species, 0.5)
        normal(self.readout_w1, 1 / math.sqrt(c.channels))
        normal(self.readout_w2, 1 / math.sqrt(c.hidden))
        for lp in self.layers:
            normal(lp.radial_w1, 1 / math.sqrt(c.n_radial))
            normal(lp.radial_w2, 1 / 32.0)
            normal(lp.mix, 1 / math.sqrt(c.channels))
            normal(lp.mb_mix, 1 / math.sqrt(c.channels))
            lp.mb_w.fill_(1.0 / c.nu)
            normal(lp.gate_w1, 1 / math.sqrt(c.channels))
            normal(lp.gate_w2, 1 / math.sqrt(32))

    def storage_dtype(self, rows: int, device) -> str:
        """The many-body chain's storage dtype: ``cfg.compute_dtype``, where
        'auto' is the measured dtype policy at the ``rows`` of the first
        call that asks, kept in the model's state (`_Picks`)."""
        c = self.cfg
        if _model_dtype(c) != "auto":
            return _model_dtype(c)
        return self._pick("dtype_pick", lambda: _engine.plan_chain(
            (c.L,) * c.nu, c.L, dtype="auto", tune=c.chain_tune, batch_hint=rows,
            share_hint=(0,) * c.nu, device=device).dtype)

    def grid_gate_on(self, rows: int, device) -> bool:
        """Whether the gate fuses into the many-body chain.  The grid gate
        is a parameterization (gate before mb_mix), so 'auto' is resolved
        once per model — by the measured policy at the ``rows`` of the
        first call that asks (the serve engine asks at warmup, at its
        largest bucket) — and kept in its state (`_Picks`): every later
        batch, served or direct, and a reload of a saved state or a
        checkpoint, evaluates the same function."""
        c = self.cfg
        if getattr(c, "grid_gate", "off") != "auto":
            return _resolve_grid_gate(c)
        return self._pick("grid_gate_pick", lambda: _resolve_grid_gate(
            c, (c.L,) * c.nu, c.L, batch_hint=rows, share_hint=(0,) * c.nu, device=device,
            dtype=self.storage_dtype(rows, device)))

    def serve_chain_keys(self, slot_atoms: list) -> list:
        """The chain keys the serve engine measures at warmup for buckets of
        ``slot_atoms`` (n_slots * max_atoms each): [(Ls, Lout, plan_chain
        keywords)], each bucket's many-body chain on atoms x channels rows
        at float32 and the storage dtype, ungated and (grid gate on) gated.
        The 'auto' storage dtype and grid gate are resolved first, at the
        largest bucket's rows.  None unless chain_tune='measure', and none
        with ``shard_data`` (its sharded chains are 'tree')."""
        c = self.cfg
        big = max(slot_atoms) * c.channels
        dts = self.storage_dtype(big, self.device)
        gates = (False, True) if self.grid_gate_on(big, self.device) else (False,)
        if c.chain_tune != "measure" or c.shard_data:
            return []
        return [((c.L,) * c.nu, c.L, dict(batch_hint=a * c.channels, share_hint=(0,) * c.nu,
                                          dtype=d, gate=g))
                for a in slot_atoms for d in dict.fromkeys(["float32", dts]) for g in gates]

    def features(self, species: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """-> per-atom invariant channels [..., n, C]."""
        c = self.cfg
        single = pos.dim() == 2
        if single:
            species, pos = species[None], pos[None]
        S, n = pos.shape[:2]
        C, dim = c.channels, num_coeffs(c.L)
        shard = _shard(c)
        # with shard_data the conv's rows split over the activation mesh's
        # data-parallel ranks
        conv = self.conv_for(pos.device)
        with span("geometry", pos):
            rhat, dist, mask = _pair_geometry(pos, c.cutoff)
            # the edge geometry is layer-constant: build what the conv needs
            # of it once for the whole stack — the filter's Fourier grid
            # (general) or the alignment rotation and Wigner blocks (eSCN)
            geom = rhat[..., None, :]
            if c.fourier_resident:
                geom = (conv.filter_rep(geom) if c.conv_impl == "general"
                        else conv.geometry_rep(geom))
            rb = radial_basis(dist, c.n_radial, c.cutoff)
        x = torch.cat([self.species[species.long()][..., None],
                       pos.new_zeros(S, n, C, dim - 1)], dim=-1)
        grid_gate = self.grid_gate_on(S * n * C, pos.device)
        dts = self.storage_dtype(S * n * C, pos.device)
        for lp in self.layers:
            with span("radial", pos):
                h = F.silu(rb @ lp.radial_w1) @ lp.radial_w2
                h = h.reshape(S, n, n, C, c.L + 1)  # per-edge per-degree weights
            with span("conv", pos):
                xj = x[:, None].expand(S, n, n, C, dim)
                m = conv(xj, geom, w1=h)
                m = (m * mask[..., None, None]).sum(dim=2)
            with span("mix", pos):
                A = equi_linear(lp.mix, m, c.L) + x
            mb_kw = dict(tune=c.chain_tune, dtype=dts, shard_spec=shard)
            if grid_gate:
                # the gate fuses into the many-body chain (gate before mb_mix)
                mb_kw["gate_params"] = lp.gate()
            with span("manybody", pos):
                B = manybody_selfmix(A, c.L, c.nu, Lout=c.L,
                                     weights=[w.expand(S, n, C, c.L + 1) for w in lp.mb_w],
                                     **mb_kw)
            with span("mb_mix", pos):
                if grid_gate:
                    x = x + equi_linear(lp.mb_mix, B, c.L)
                else:
                    # the reference's gate_apply: scalars gate higher degrees
                    x = x + _gate_sh(lp.gate(), equi_linear(lp.mb_mix, B, c.L))
        out = x[..., 0]
        return out[0] if single else out

    def _atom_energies(self, species, pos) -> torch.Tensor:
        feat = self.features(species, pos)
        with span("readout", pos):
            return (F.silu(feat @ self.readout_w1) @ self.readout_w2)[..., 0]

    def energy(self, species: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Total energy (scalar, or [S] for a batch of molecules)."""
        return self._atom_energies(species, pos).sum(-1)

    def energy_masked(self, species, pos, mask) -> torch.Tensor:
        """Energy of the atoms selected by ``mask`` [..., n] (serving parks
        ghost atoms beyond the cutoff and masks them out here)."""
        return (self._atom_energies(species, pos) * mask).sum(-1)

    def energy_forces(self, species, pos):
        """(energy, forces = -dE/dpos), detached: the served evaluation."""
        pos = pos.detach().requires_grad_(True)
        e = self.energy(species, pos)
        (g,) = torch.autograd.grad(e.sum(), pos)
        return e.detach(), -g

    def loss(self, batch: dict, w_e: float = 1.0, w_f: float = 10.0) -> torch.Tensor:
        """Energy + force matching loss over a batch of molecules: species
        [S, n], pos [S, n, 3], energy [S], forces [S, n, 3] ->
        mean_S( w_e (E - E_ref)^2 + w_f mean((F - F_ref)^2) ).

        One pass over the stacked batch (the molecules never interact, so
        this equals the reference's vmap over molecules).  The forces keep
        their graph (``create_graph=True``), so ``loss.backward()`` reaches
        the parameters through the second derivative."""
        pos = batch["pos"].detach().requires_grad_(True)
        e = self.energy(batch["species"], pos)
        (g,) = torch.autograd.grad(e.sum(), pos, create_graph=True)
        de = (e - batch["energy"]) ** 2
        df = ((-g - batch["forces"]) ** 2).mean(dim=(-2, -1))
        return (w_e * de + w_f * df).mean()


# --------------------------------------------------------------------------
# SEGNN-like N-body
# --------------------------------------------------------------------------


class SegnnLayer(nn.Module):
    """One message-passing layer's parameters."""

    def __init__(self, c: EquivariantConfig, device):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.radial_w1 = p(c.n_radial, 32)
        self.radial_w2 = p(32, c.channels * (c.L + 1))
        self.mix = p(c.L + 1, c.channels, c.channels)
        self.self_mix = p(c.L + 1, c.channels, c.channels)
        self.gate_w1 = p(c.channels, 32)
        self.gate_w2 = p(32, c.channels)

    def gate(self) -> dict:
        return {"w1": self.gate_w1, "w2": self.gate_w2}


class SegnnNBody(_Picks):
    """SEGNN-like N-body model: predicts positions after the simulation
    horizon from charges, positions and velocities.  ``device=None`` means
    CUDA (raises without a GPU); pass ``device='cpu'`` for the plain path.
    Parameters from ``init(generator)`` or, for parity with the reference,
    from `models.convert.segnn_params_from_jax` via ``load_state_dict``.
    An 'auto' storage dtype is resolved once and kept in the state
    (`_Picks`)."""

    _PICKS = {"dtype_pick": ("float32", "bfloat16")}

    def __init__(self, cfg: EquivariantConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        c, dev = cfg, self.device
        self.embed = nn.Parameter(torch.empty(c.L + 1, 2, c.channels, device=dev))
        self.out = nn.Parameter(torch.empty(c.L + 1, c.channels, 1, device=dev))
        self.layers = nn.ModuleList(SegnnLayer(c, dev) for _ in range(c.n_layers))
        self._init_picks(dev)
        self.init(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Random parameters with the reference's scales (a CPU generator)."""
        c = self.cfg

        def normal(t, scale):
            t.copy_(torch.randn(t.shape, generator=generator) * scale)

        normal(self.embed, 1 / math.sqrt(2))
        normal(self.out, 1 / math.sqrt(c.channels))
        for lp in self.layers:
            normal(lp.radial_w1, 1 / math.sqrt(c.n_radial))
            normal(lp.radial_w2, 1 / 32.0)
            normal(lp.mix, 1 / math.sqrt(c.channels))
            normal(lp.self_mix, 1 / math.sqrt(c.channels))
            normal(lp.gate_w1, 1 / math.sqrt(c.channels))
            normal(lp.gate_w2, 1 / math.sqrt(32))

    def storage_dtype(self, rows: int, device) -> str:
        """The edge product's storage dtype: ``cfg.compute_dtype``, where
        'auto' is what the product's own plan resolves at the ``rows`` of
        the first call that asks, kept in the model's state (`_Picks`)."""
        c = self.cfg
        if _model_dtype(c) != "auto":
            return _model_dtype(c)

        def resolve():
            if _tp_resident(c, c.L, c.L_edge, c.L, device, "auto") is not None:
                tune = getattr(c, "chain_tune", "heuristic")
                return _engine.plan_chain(
                    (c.L, c.L_edge), c.L, dtype="auto", tune=tune, entry_hint=("sh", "fourier"),
                    batch_hint=rows if tune == "measure" else None, device=device).dtype
            if c.tp_impl in _TP_BACKEND:
                return _engine.plan_batch(
                    [(c.L, c.L_edge, c.L)], backend=_resolve_tp_backend(c.tp_impl, c.L, c.L_edge),
                    dtype="auto", device=device).buckets[0].plan.key.dtype
            return "float32"
        return self._pick("dtype_pick", resolve)

    def _node_feats(self, charge: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
        """2-channel input irreps: ch0 = (charge; velocity as l=1), ch1 =
        (|v|; velocity); the l=1 slots in (y, z, x) order."""
        v_sh = torch.stack([vel[..., 1], vel[..., 2], vel[..., 0]], dim=-1)
        rest = vel.new_zeros(*vel.shape[:-1], num_coeffs(self.cfg.L) - 4)
        ch0 = torch.cat([charge[..., None], v_sh, rest], dim=-1)
        ch1 = torch.cat([torch.linalg.norm(vel, dim=-1)[..., None], v_sh, rest], dim=-1)
        return torch.stack([ch0, ch1], dim=-2)

    def forward(self, charge: torch.Tensor, pos: torch.Tensor,
                vel: torch.Tensor) -> torch.Tensor:
        """charge [..., n], pos and vel [..., n, 3] -> predicted positions
        [..., n, 3]; a leading batch of systems runs in one pass."""
        c = self.cfg
        single = pos.dim() == 2
        if single:
            charge, pos, vel = charge[None], pos[None], vel[None]
        S, n = pos.shape[:2]
        C, dim = c.channels, num_coeffs(c.L)
        rhat, dist, mask = _pair_geometry(pos, cutoff=1e9)  # fully connected
        x = equi_linear(self.embed, self._node_feats(charge, vel), c.L)
        edge_sh = real_sph_harm_torch(c.L_edge, rhat)        # [S, n, n, (Le+1)^2]
        # the edge filter is layer-constant: on the resident route it
        # converts to the Fourier basis once for the whole stack
        dts = self.storage_dtype(S * n * n * C, pos.device)
        res = _tp_resident(c, c.L, c.L_edge, c.L, pos.device, dts)
        if res is not None:
            to_rep, tp_res = res
            edge_rep = to_rep(edge_sh[..., None, :])         # broadcasts over C
            tp = lambda a: tp_res(a, edge_rep)  # noqa: E731
        else:
            tp0 = _tp(c, c.L, c.L_edge, c.L, pos.device, dts)
            tp = lambda a: tp0(a, edge_sh[..., None, :].expand(  # noqa: E731
                S, n, n, C, edge_sh.shape[-1]))
        # SEGNN's gate sits after the channel mix, so no chain can absorb
        # it; 'on' evaluates it on the quadrature grid (the same function).
        # It adds a quadrature round trip rather than eliding one, so 'auto'
        # resolves to off here, as in the reference
        gg = getattr(c, "grid_gate", "off")
        if gg not in ("off", "on", "grid", "auto", True, False, None):
            raise ValueError(f"unknown grid_gate {gg!r}")
        use_quad_gate = gg in ("on", "grid", True)
        rb = radial_basis(dist, c.n_radial, cutoff=10.0)
        for lp in self.layers:
            h = (F.silu(rb @ lp.radial_w1) @ lp.radial_w2).reshape(S, n, n, C, c.L + 1)
            xj = x[:, None].expand(S, n, n, C, dim)
            m = tp(xj * expand_degree_weights(h, c.L))
            m = (m * mask[..., None, None]).sum(dim=2)[..., :dim]
            y = equi_linear(lp.mix, m, c.L)
            x = x + (_gate_quad(lp.gate(), y, c.L) if use_quad_gate
                     else _gate_sh(lp.gate(), y))
            x = x + equi_linear(lp.self_mix, x, c.L)
        out = equi_linear(self.out, x, c.L)[..., 0, :]      # [S, n, dim]
        dsh = out[..., 1:4]                                 # the l=1 block (y, z, x)
        pred = pos + torch.stack([dsh[..., 2], dsh[..., 0], dsh[..., 1]], dim=-1)
        return pred[0] if single else pred

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean squared position error over a batch of systems: charge
        [S, n], pos, vel and target [S, n, 3] -> mean_S mean((pred -
        target)^2), one pass over the stacked batch."""
        pred = self.forward(batch["charge"], batch["pos"], batch["vel"])
        return ((pred - batch["target"]) ** 2).mean(dim=(-2, -1)).mean()


# --------------------------------------------------------------------------
# EquiformerV2-like Selfmix (Equivariant Feature Interaction)
# --------------------------------------------------------------------------


class SelfmixLayer(_Picks):
    """x -> x + mix(GauntTP(w1 . x, w2 . x)), the paper's added layer.

    ``tp_impl='gaunt'`` with ``resident`` runs a 2-operand chain plan: the
    operands are one tensor under two per-degree weights, so the tree route
    converts it once (degree-resolved) for both, and ``tune='measure'``
    may put the chain on the kernel.  Otherwise 'gaunt', 'gaunt_fused' and
    'gaunt_auto' run one batched pairwise plan, and 'cg' the CG baseline
    (a different parameterization: its weights are per path).
    ``compute_dtype`` is the product's storage dtype ('float32' |
    'bfloat16' | 'auto'; 'auto' is resolved once and kept in the state,
    `_Picks`).  ``shard_spec`` (`engine.ShardSpec`) splits the product's
    rows over the mesh's data-parallel ranks on every route but 'cg'."""

    _PICKS = {"dtype_pick": ("float32", "bfloat16")}

    def __init__(self, L: int, channels: int, tp_impl: str = "gaunt",
                 resident: bool = True, tune: str = "heuristic",
                 compute_dtype: str = "float32", shard_spec=None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.shard_spec = shard_spec
        self.L, self.channels = L, channels
        self.tp_impl, self.resident, self.tune = tp_impl, resident, tune
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        dev = self.device
        self.w1 = nn.Parameter(torch.empty(L + 1, device=dev))
        self.w2 = nn.Parameter(torch.empty(L + 1, device=dev))
        self.w3 = nn.Parameter(torch.empty(2 * L + 1, device=dev))
        self.mix = nn.Parameter(torch.empty(L + 1, channels, channels, device=dev))
        self._init_picks(dev)
        self.init(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Unit per-degree weights and a random channel mix, as the reference."""
        for w in (self.w1, self.w2, self.w3):
            w.fill_(1.0)
        self.mix.copy_(torch.randn(self.mix.shape, generator=generator)
                       / math.sqrt(self.channels))

    def chain_plan(self, x: torch.Tensor, dtype: str | None = None):
        """The resident route's chain plan for input ``x`` (planned per call
        so 'measure' keys on the real row count; a cached lookup after), at
        ``dtype`` (default: the layer's storage dtype)."""
        hint = int(np.prod(x.shape[:-1])) if self.tune == "measure" else None
        return _engine.plan_chain((self.L, self.L), Lout=self.L, tune=self.tune,
                                  batch_hint=hint, share_hint=(0, 0) if hint else None,
                                  dtype=dtype or self.storage_dtype(x),
                                  shard_spec=self.shard_spec, device=x.device)

    def _pair_plan(self, x: torch.Tensor, dtype: str):
        L = self.L
        return _engine.plan_batch([(L, L, L)], kind="pairwise",
                                  backend=_resolve_tp_backend(self.tp_impl, L, L),
                                  dtype=dtype, shard_spec=self.shard_spec, device=x.device)

    def storage_dtype(self, x: torch.Tensor) -> str:
        """The product's storage dtype: ``compute_dtype``, where 'auto' is
        what the route's own plan resolves for the first input that asks,
        kept in the layer's state (`_Picks`)."""
        if self.compute_dtype != "auto":
            return self.compute_dtype

        def resolve():
            if self.tp_impl == "gaunt" and self.resident:
                return self.chain_plan(x, "auto").dtype
            if self.tp_impl in _TP_BACKEND:
                return self._pair_plan(x, "auto").buckets[0].plan.key.dtype
            return "float32"
        return self._pick("dtype_pick", resolve)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., C, (L+1)^2] -> the same shape."""
        L = self.L
        w3 = self.w3[: L + 1]
        if self.tp_impl == "gaunt" and self.resident:
            y = self.chain_plan(x).apply([x, x], weights=[self.w1, self.w2], w_out=w3)
        elif self.tp_impl in _TP_BACKEND:
            dts = self.storage_dtype(x)
            xd = _cast_sd(x, dts)
            bp = self._pair_plan(x, dts)
            y = bp.apply([(xd, xd)], weights=[(self.w1, self.w2, w3)])[0]
        else:
            xw = x * expand_degree_weights(self.w1, L)
            yw = x * expand_degree_weights(self.w2, L)
            y = cg_full_tensor_product(xw, yw, L, L, L) * expand_degree_weights(w3, L)
        return x + equi_linear(self.mix, y, L)
