"""The paper's MACE-like force field on the Gaunt ops, in PyTorch.

Each layer: an eSCN equivariant convolution of neighbour features against
the edge geometry (messages summed over neighbours within the cutoff), a
degree-wise channel mix with a residual, the nu-fold many-body self-product
(one chain plan — on the collocation kernel when ``chain_tune='measure'``
picks it), a second channel mix and the equivariant gate.
``compute_dtype='bfloat16'`` stores the many-body chain at bf16 (entry
cast, bf16 exit), as in the reference; the conv, the mixes and the gate
stay f32, the mixes promoting the bf16 exit.  Energy is a sum
of per-atom readouts of the invariant channels; forces are -dE/dpos by
autograd, and the training loss (`MaceGaunt.loss`) differentiates them
once more.

Layouts match the reference: features x [..., n, C, (L+1)^2], positions
[..., n, 3].  Every method also takes a leading batch of molecules
(pos [S, n, 3], species [S, n]), which is how serving evaluates all its
slots in one pass: the molecules never interact, so one backward of the
summed energies gives every molecule's forces.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.gaunt_ff import EquivariantConfig
from ..core.constants import to_torch
from ..core.conv import EquivariantConv, axis_vector
from ..core.engine import _gate_sh
from ..core.irreps import l_array, num_coeffs
from ..core.manybody import manybody_selfmix
from ..device import resolve_device

__all__ = ["MaceGaunt", "equi_linear", "radial_basis"]


def equi_linear(w: torch.Tensor, x: torch.Tensor, L: int) -> torch.Tensor:
    """Degree-wise channel mixing: x [..., C, (L+1)^2] @ w [L+1, C, C'], at
    the promoted dtype of the two (a bf16 chain exit against f32 weights
    mixes in f32, as ``jnp.einsum`` promotes in the reference)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    wl = w[to_torch(l_array(L), w.device, torch.int64)]
    return torch.einsum("...ck,kcd->...dk", x.to(dt), wl.to(dt))


def _resolve_grid_gate(cfg) -> bool:
    mode = getattr(cfg, "grid_gate", "off")
    if mode in ("off", None, False):
        return False
    if mode in ("on", "grid", True):
        return True
    if mode == "auto":
        raise NotImplementedError("grid_gate='auto' (the measured gate policy) "
                                  "is not ported; use 'on' or 'off'")
    raise ValueError(f"unknown grid_gate {mode!r}")


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


class MaceGaunt(nn.Module):
    """MACE-like force field.  ``device=None`` means CUDA (raises without a
    GPU); pass ``device='cpu'`` for the plain path.  Parameters come from
    ``init(generator)`` (random, seeded) or, for parity with the reference,
    from `models.convert.params_from_jax` via ``load_state_dict``."""

    def __init__(self, cfg: EquivariantConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.conv_impl != "escn":
            raise NotImplementedError(f"conv_impl {cfg.conv_impl!r} is not ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        c, dev = cfg, self.device
        self.species = nn.Parameter(torch.empty(c.n_species, c.channels, device=dev))
        self.readout_w1 = nn.Parameter(torch.empty(c.channels, c.hidden, device=dev))
        self.readout_w2 = nn.Parameter(torch.empty(c.hidden, 1, device=dev))
        self.layers = nn.ModuleList(MaceLayer(c, dev) for _ in range(c.n_layers))
        self.conv = EquivariantConv(c.L, c.L_edge, c.L, method=c.conv_impl)
        self.init(generator if generator is not None else torch.Generator().manual_seed(0))

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

    def features(self, species: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """-> per-atom invariant channels [..., n, C]."""
        c = self.cfg
        single = pos.dim() == 2
        if single:
            species, pos = species[None], pos[None]
        S, n = pos.shape[:2]
        C, dim = c.channels, num_coeffs(c.L)
        rhat, dist, mask = _pair_geometry(pos, c.cutoff)
        # the edge geometry is layer-constant: hoist the alignment rotation
        # and Wigner recursion out of the layer loop
        geom = (self.conv.geometry_rep(rhat[..., None, :]) if c.fourier_resident
                else rhat[..., None, :])
        x = torch.cat([self.species[species.long()][..., None],
                       pos.new_zeros(S, n, C, dim - 1)], dim=-1)
        grid_gate = _resolve_grid_gate(c)
        rb = radial_basis(dist, c.n_radial, c.cutoff)
        for lp in self.layers:
            h = F.silu(rb @ lp.radial_w1) @ lp.radial_w2
            h = h.reshape(S, n, n, C, c.L + 1)  # per-edge per-degree weights
            xj = x[:, None].expand(S, n, n, C, dim)
            m = self.conv(xj, geom, w1=h)
            m = (m * mask[..., None, None]).sum(dim=2)
            A = equi_linear(lp.mix, m, c.L) + x
            mb_kw = dict(weights=[w.expand(S, n, C, c.L + 1) for w in lp.mb_w],
                         tune=c.chain_tune, dtype=c.compute_dtype)
            if grid_gate:
                # the gate fuses into the many-body chain (gate before mb_mix)
                B = manybody_selfmix(A, c.L, c.nu, Lout=c.L, gate_params=lp.gate(), **mb_kw)
                x = x + equi_linear(lp.mb_mix, B, c.L)
            else:
                B = manybody_selfmix(A, c.L, c.nu, Lout=c.L, **mb_kw)
                # the reference's gate_apply: scalars gate higher degrees
                x = x + _gate_sh(lp.gate(), equi_linear(lp.mb_mix, B, c.L))
        out = x[..., 0]
        return out[0] if single else out

    def _atom_energies(self, species, pos) -> torch.Tensor:
        feat = self.features(species, pos)
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
