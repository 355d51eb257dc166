"""EquiformerV2 with the paper's Gaunt Selfmix, in PyTorch: the OC20 S2EF
model of arXiv:2306.12059 with the Equivariant Feature Interaction of
arXiv:2401.10216 (its Table 1) in each block.

Features are x [S, n, C, (L+1)^2] in the port's packed real-SH layout
(index l*l + l + m, orthonormal harmonics with z the polar axis), for S
systems of n atoms (ghost atoms masked).  The model, equation by equation
(C sphere channels, l_max L, m_max M, H heads, dropout and drop-path
identity):

- Graph.  For each real atom i, its sources j are the K = max_neighbors
  nearest other real atoms with |r_j - r_i| < cutoff, chosen by squared
  distances computed in float64 from the float32 positions as dx*dx +
  dy*dy + dz*dz, ties broken by the lower index (a stable sort).  An atom
  with fewer has masked slots; a ghost atom has none.  Edge i <- j:
  r_ij = r_j - r_i, d_ij = |r_ij|.
- Edge frame.  R_ij has the rows (b1, b2, u), u = r_ij / d_ij, b1 = t x u /
  |t x u| with t = e_z where |u_x| > 0.9 and e_x elsewhere, b2 = u x b1
  (`conv.align_rotation`: R u = e_z), and its Wigner blocks, D(R) S(v) =
  S(R v), are cut to |m| <= M (`conv.edge_frame_wigner`,
  the 1 + 3 + 5 (L-1) = 29 coefficients at L = 6, M = 2, in m-primary
  order): x -> W x into the frame, y -> W^T y back.  The roll about the
  edge axis is free up to the S^2 grid's aliasing: every map in the frame
  is an SO(2) map.
- Edge scalars.  e_ij = [exp(-(d_ij - mu_k)^2 / (2 (w delta)^2))_k, s(z_j),
  t(z_i)]: n_gaussians centres mu_k evenly from 0 to the cutoff, delta their
  spacing, w = gaussian_width; s and t are a module's source and target
  element embeddings.  A radial MLP is Linear-LayerNorm-SiLU twice, then a
  Linear.
- Embedding.  x_i = [E(z_i) at l = 0, 0 elsewhere] + (1 / avg_degree)
  sum_j W_ij^T [rad(e_ij) as the m = 0 coefficients of every degree].
- Block b = 1..L_blocks:  x <- x + Attn(SLN(x));  x <- x + FFN(SLN(x));
  x <- Selfmix(x).
- SLN (separable layer norm): l = 0 by LayerNorm over the channels; l > 0
  times a_{l,c} / sqrt(s + 1e-5), s the mean over channels of
  (1/L) sum_{l>=1} (1/(2l+1)) sum_m x_{lm,c}^2 (one scale per atom).
- SO(2) convolution of edge-frame features y [C_in, 29] under radial
  weights r: for m = 0 the flattened (channel-major) y_{m=0} * r_0 through
  one Linear with bias, whose first outputs are the extra scalars; for
  each m >= 1, with A|B = the Linear (no bias) of (y_{+m} * r_m) and
  A'|B' that of (y_{-m} * r_m): out_{+m} = A - B', out_{-m} = A' + B.
- Attn: y = W_ij cat(x_j, x_i) (2C channels); y1, extra = SO2conv_1(y,
  rad(e_ij)) (attn_hidden channels; extra = H attn_alpha alpha channels,
  then attn_hidden gate scalars); logits = sum_a SmoothLeakyReLU_0.2(
  LayerNorm(alpha_h))_a dot_{h,a}; alpha = exp(l - max) / (sum_j exp(l -
  max) + 1e-16) over the valid edges into i; the separable S^2
  activation: l = 0 <- SiLU(gate scalars), l > 0 <- from_grid(SiLU(
  to_grid(y1))) on the (L, M) grid; y2 = SO2conv_2(.) (no radial weights,
  H attn_value channels); messages alpha_h y2_h, rotated back by W_ij^T
  and summed over j; an equivariant linear map (per-degree weights, bias
  on l = 0) to the output channels.
- FFN: h = lin_1(x) (C -> ffn_hidden); on the (L, L) grid: from_grid(
  W_3 SiLU(W_2 SiLU(W_1 to_grid(h)))) (bias-free Linears over channels);
  l = 0 <- SiLU(scalar Linear of x's l = 0); lin_2 to the output channels.
- Selfmix: the port's `SelfmixLayer` (x + mix(Gaunt(w1 . x, w2 . x) w3),
  truncated at L; on the chain kernel when chain_tune='measure' picks it).
- Heads: x_f = SLN(x); E = (1 / avg_num_nodes) sum_i mask_i FFN_E(x_f)_i
  (one output channel, its l = 0); F_i = the l = 1 coefficients of an
  Attn block with one output channel (direct, not -dE/dr), read as
  (y, z, x) in the port's layout.

The S^2 grid (`so3.s2_grid_matrices`): grid_res Gauss-Legendre latitudes
by grid_res uniform longitudes, to_grid the harmonics at the points,
from_grid the quadrature projection; on the edge-frame grid (M < L) the
degrees l > M carry EquiformerV2's rescale sqrt((2l+1)/(2M+1)) both ways.

Departures from the published model, by choice of the port: the grid's
latitudes are Gauss-Legendre nodes (e3nn's equiangular ones in the public
code); each flattened (degree, channel) axis is channel-major (the public
code's is degree-major: a permutation of random weights); the Gaussian
width, the average atom count and the average degree are the public
code's constants; one Selfmix a block, after the FFN's residual (the
paper does not say where).  Forces come out of the forward pass, so the
served step runs it under ``no_grad`` (`energy_forces_masked`).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.gaunt_ff import EquiformerV2Config
from ..core.constants import to_torch
from ..core.conv import align_rotation, axis_vector, edge_frame_index, edge_frame_wigner, \
    wigner_blocks_from_rotmat
from ..core.so3 import s2_grid_matrices
from ..device import resolve_device
from ..spans import span
from .equivariant import SelfmixLayer, equi_linear

__all__ = ["EquiformerV2Gaunt", "neighbor_graph"]

_LN_EPS = 1e-5
SELFMIX_SCALE = 0.05  # the default init's Selfmix channel mix, against SelfmixLayer's


def neighbor_graph(pos: torch.Tensor, mask: torch.Tensor, cutoff: float, k: int):
    """(nbr [S, n, k'] int64, valid [S, n, k'] bool), k' = min(k, n): each
    atom's sources, the nearest real atoms under the cutoff by float64
    squared distance of the float32 positions, ties to the lower index."""
    p = pos.double()
    d = p[..., None, :, :] - p[..., :, None, :]          # [S, i, j, 3]: r_j - r_i
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    n = pos.shape[-2]
    real = mask > 0
    ok = (real[..., :, None] & real[..., None, :]
          & ~torch.eye(n, dtype=torch.bool, device=pos.device) & (d2 < cutoff * cutoff))
    d2 = torch.where(ok, d2, torch.full_like(d2, math.inf))
    d2s, order = torch.sort(d2, dim=-1, stable=True)
    kk = min(k, n)
    return order[..., :kk], torch.isfinite(d2s[..., :kk])


@lru_cache(maxsize=None)
def _grids(L: int, m_max: int, res: int):
    """(edge-frame to_grid, from_grid [res^2, n_edge], node to_grid, from_grid
    [res^2, (L+1)^2]) as contiguous float64 arrays (cached: stable ids for
    `to_torch`)."""
    cols = edge_frame_index(L, m_max)
    te, fe = s2_grid_matrices(L, res, m_max)
    tn, fn = s2_grid_matrices(L, res)
    return tuple(np.ascontiguousarray(a) for a in (te[:, cols], fe[:, cols], tn, fn))


def _param(*shape, device):
    return nn.Parameter(torch.empty(*shape, device=device))


def _radial(mod, e: torch.Tensor) -> torch.Tensor:
    """The radial MLP of a module holding rad_{w,b}{1,2,3}, rad_ln{1,2}_{w,b}."""
    h = e
    for i in (1, 2):
        h = h @ getattr(mod, f"rad_w{i}") + getattr(mod, f"rad_b{i}")
        h = F.silu(F.layer_norm(h, h.shape[-1:], getattr(mod, f"rad_ln{i}_w"),
                                getattr(mod, f"rad_ln{i}_b"), _LN_EPS))
    return h @ mod.rad_w3 + mod.rad_b3


def _add_radial(mod, n_in: int, c: int, n_out: int, device) -> None:
    for i, (a, b) in enumerate([(n_in, c), (c, c)], start=1):
        setattr(mod, f"rad_w{i}", _param(a, b, device=device))
        setattr(mod, f"rad_b{i}", _param(b, device=device))
        setattr(mod, f"rad_ln{i}_w", _param(b, device=device))
        setattr(mod, f"rad_ln{i}_b", _param(b, device=device))
    mod.rad_w3 = _param(c, n_out, device=device)
    mod.rad_b3 = _param(n_out, device=device)


def _lin(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, L: int) -> torch.Tensor:
    """Equivariant linear map: per-degree weights w [L+1, c_in, c_out], bias
    b [c_out] on l = 0."""
    y = equi_linear(w, x, L)
    return torch.cat([y[..., :1] + b[:, None], y[..., 1:]], dim=-1)


def _smooth_leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return 0.5 * (1 + slope) * x + 0.5 * (1 - slope) * x * (2 * torch.sigmoid(x) - 1)


class _SLN(nn.Module):
    """Separable layer norm: LayerNorm on l = 0, one RMS over the degrees
    l > 0 (each degree's mean square weighted 1/(2l+1), averaged over
    degrees and channels) with a learned scale a degree and channel."""

    def __init__(self, L: int, C: int, device):
        super().__init__()
        self.L = L
        self.ln_w, self.ln_b = _param(C, device=device), _param(C, device=device)
        self.sln_affine = _param(L, C, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.L
        x0 = F.layer_norm(x[..., 0], x.shape[-2:-1], self.ln_w, self.ln_b, _LN_EPS)
        sq = x[..., 1:] * x[..., 1:]
        s = sum(sq[..., l * l - 1:(l + 1) ** 2 - 1].sum(-1) / (2 * l + 1)
                for l in range(1, L + 1)) / L                  # [..., C]
        inv = torch.rsqrt(s.mean(-1, keepdim=True) + _LN_EPS)  # [..., 1]
        out = [x0[..., None]]
        for l in range(1, L + 1):
            out.append(x[..., l * l:(l + 1) ** 2]
                       * (inv * self.sln_affine[l - 1])[..., None])
        return torch.cat(out, dim=-1)


def _so2_conv(mod, prefix: str, y: torch.Tensor, L: int, m_max: int, c_out: int,
              rad: torch.Tensor | None = None, n_extra: int = 0):
    """SO(2) convolution of edge-frame features y [..., c_in, n_edge]
    (m-primary) -> (out [..., c_out, n_edge], the m = 0 Linear's first
    ``n_extra`` outputs).  Flattened axes are channel-major."""
    lead, c_in = y.shape[:-2], y.shape[-2]

    def flat(a):
        return a.reshape(*lead, -1)

    y0 = flat(y[..., :L + 1])
    if rad is not None:
        y0 = y0 * rad[..., :c_in * (L + 1)]
    o0 = y0 @ getattr(mod, f"{prefix}_m0_w") + getattr(mod, f"{prefix}_m0_b")
    outs = [o0[..., n_extra:].reshape(*lead, c_out, L + 1)]
    off, roff = L + 1, c_in * (L + 1)
    for m in range(1, m_max + 1):
        nl = L - m + 1
        yp, yn = flat(y[..., off:off + nl]), flat(y[..., off + nl:off + 2 * nl])
        if rad is not None:
            r = rad[..., roff:roff + c_in * nl]
            yp, yn = yp * r, yn * r
        w = getattr(mod, f"{prefix}_m{m}_w")
        ap, an = yp @ w, yn @ w
        half = c_out * nl
        outs += [(ap[..., :half] - an[..., half:]).reshape(*lead, c_out, nl),
                 (an[..., :half] + ap[..., half:]).reshape(*lead, c_out, nl)]
        off, roff = off + 2 * nl, roff + c_in * nl
    return torch.cat(outs, dim=-1), o0[..., :n_extra]


class _Attention(nn.Module):
    """Equivariant graph attention (SO2EquivariantGraphAttention) with
    ``c_out`` output channels."""

    def __init__(self, c: EquiformerV2Config, c_out: int, device):
        super().__init__()
        self.cfg, self.c_out = c, c_out
        L, M, C, Ec = c.L, c.m_max, c.channels, c.edge_channels
        Ha, H, A, HV = c.attn_hidden, c.n_heads, c.attn_alpha, c.n_heads * c.attn_value
        self.n_extra = H * A + Ha
        self.source_embedding = _param(c.n_species, Ec, device=device)
        self.target_embedding = _param(c.n_species, Ec, device=device)
        n_rad = 2 * C * sum(L + 1 - m for m in range(M + 1))
        _add_radial(self, c.n_gaussians + 2 * Ec, Ec, n_rad, device)
        for prefix, ci, co, extra in (("conv1", 2 * C, Ha, self.n_extra), ("conv2", Ha, HV, 0)):
            setattr(self, f"{prefix}_m0_w", _param(ci * (L + 1), extra + co * (L + 1),
                                                   device=device))
            setattr(self, f"{prefix}_m0_b", _param(extra + co * (L + 1), device=device))
            for m in range(1, M + 1):
                setattr(self, f"{prefix}_m{m}_w", _param(ci * (L + 1 - m),
                                                         2 * co * (L + 1 - m), device=device))
        self.alpha_ln_w, self.alpha_ln_b = _param(A, device=device), _param(A, device=device)
        self.alpha_dot = _param(H, A, device=device)
        self.proj_w = _param(L + 1, HV, c_out, device=device)
        self.proj_b = _param(c_out, device=device)

    def forward(self, x: torch.Tensor, g: dict) -> torch.Tensor:
        c = self.cfg
        L, M, H, A, V = c.L, c.m_max, c.n_heads, c.attn_alpha, c.attn_value
        S, n, C, D = x.shape
        xs = x.reshape(S * n, C, D)[g["src"]]                           # [S, n, k, C, D]
        xm = torch.cat([xs, x[:, :, None].expand_as(xs)], dim=-2)
        y = xm @ g["W"].transpose(-1, -2)                               # [S, n, k, 2C, 29]
        e = torch.cat([g["rbf"], self.source_embedding[g["z_src"]],
                       self.target_embedding[g["z_dst"]]], dim=-1)
        y, extra = _so2_conv(self, "conv1", y, L, M, c.attn_hidden, _radial(self, e),
                             self.n_extra)
        a = extra[..., :H * A].reshape(*extra.shape[:-1], H, A)
        a = _smooth_leaky_relu(F.layer_norm(a, (A,), self.alpha_ln_w, self.alpha_ln_b,
                                            _LN_EPS))
        logits = (a * self.alpha_dot).sum(-1)                           # [S, n, k, H]
        valid = g["valid"][..., None]
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
        ex = torch.exp(logits - logits.amax(dim=2, keepdim=True)) * valid
        alpha = ex / (ex.sum(dim=2, keepdim=True) + 1e-16)
        to_g, from_g = g["edge_grid"]
        act = F.silu(y @ to_g.T) @ from_g                               # [S, n, k, Ha, 29]
        y = torch.cat([F.silu(extra[..., H * A:])[..., None], act[..., 1:]], dim=-1)
        v, _ = _so2_conv(self, "conv2", y, L, M, H * V)
        v = (v.reshape(S, n, -1, H, V, v.shape[-1]) * alpha[..., None, None]).flatten(3, 4)
        msg = (v @ g["W"]).sum(dim=2)                                   # [S, n, HV, D]
        return _lin(self.proj_w, self.proj_b, msg, L)


class _FFN(nn.Module):
    """Feed-forward network on the (L, L) grid, with ``c_out`` output
    channels."""

    def __init__(self, c: EquiformerV2Config, c_out: int, device):
        super().__init__()
        L, C, Fh = c.L, c.channels, c.ffn_hidden
        self.L = L
        self.lin1_w, self.lin1_b = _param(L + 1, C, Fh, device=device), _param(Fh, device=device)
        self.scalar_w, self.scalar_b = _param(C, Fh, device=device), _param(Fh, device=device)
        for i in (1, 2, 3):
            setattr(self, f"grid_w{i}", _param(Fh, Fh, device=device))
        self.lin2_w = _param(L + 1, Fh, c_out, device=device)
        self.lin2_b = _param(c_out, device=device)

    def forward(self, x: torch.Tensor, grid) -> torch.Tensor:
        to_g, from_g = grid
        gate = F.silu(x[..., 0] @ self.scalar_w + self.scalar_b)
        h = _lin(self.lin1_w, self.lin1_b, x, self.L)                  # [..., F, D]
        p = (h @ to_g.T).transpose(-1, -2)                              # [..., G, F]
        p = F.silu(F.silu(p @ self.grid_w1) @ self.grid_w2) @ self.grid_w3
        h = p.transpose(-1, -2) @ from_g                                # [..., F, D]
        h = torch.cat([gate[..., None], h[..., 1:]], dim=-1)
        return _lin(self.lin2_w, self.lin2_b, h, self.L)


class _EdgeDegree(nn.Module):
    """The edge-degree embedding: m = 0 coefficients of every degree from a
    radial MLP, rotated back and summed over each atom's edges."""

    def __init__(self, c: EquiformerV2Config, device):
        super().__init__()
        self.cfg = c
        self.source_embedding = _param(c.n_species, c.edge_channels, device=device)
        self.target_embedding = _param(c.n_species, c.edge_channels, device=device)
        _add_radial(self, c.n_gaussians + 2 * c.edge_channels, c.edge_channels,
                    c.channels * (c.L + 1), device)

    def forward(self, g: dict) -> torch.Tensor:
        c = self.cfg
        e = torch.cat([g["rbf"], self.source_embedding[g["z_src"]],
                       self.target_embedding[g["z_dst"]]], dim=-1)
        m0 = _radial(self, e).reshape(*e.shape[:-1], c.channels, c.L + 1)
        m0 = m0 * g["valid"][..., None, None]
        return (m0 @ g["W"][..., :c.L + 1, :]).sum(dim=2) / c.avg_degree


class _Block(nn.Module):
    def __init__(self, c: EquiformerV2Config, device, generator):
        super().__init__()
        self.norm_1 = _SLN(c.L, c.channels, device)
        self.ga = _Attention(c, c.channels, device)
        self.norm_2 = _SLN(c.L, c.channels, device)
        self.ffn = _FFN(c, c.channels, device)
        self.selfmix = SelfmixLayer(c.L, c.channels, tp_impl="gaunt", resident=True,
                                    tune=c.chain_tune, device=device, generator=generator)


class EquiformerV2Gaunt(nn.Module):
    """EquiformerV2 with a Gaunt Selfmix a block (the module docstring).
    ``device=None`` means CUDA (raises without a GPU); ``device='cpu'`` for
    the plain path.  Parameters from ``init(generator)`` (random, seeded)
    or ``load_state_dict``.  Served through `EquivariantServeEngine` from
    `energy_forces_masked`, forward only."""

    def __init__(self, cfg: EquiformerV2Config, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: only 'float32'")
        self.cfg = cfg
        self.device = resolve_device(device)
        c, dev = cfg, self.device
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.sphere_embedding = _param(c.n_species, c.channels, device=dev)
        self.edge_degree = _EdgeDegree(c, dev)
        self.blocks = nn.ModuleList(_Block(c, dev, gen) for _ in range(c.n_layers))
        self.norm = _SLN(c.L, c.channels, dev)
        self.energy_block = _FFN(c, 1, dev)
        self.force_block = _Attention(c, 1, dev)
        self.init(gen)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Random parameters from a CPU generator (the same seed gives the
        same weights on every device): weights N(0, 1/fan_in), embeddings
        N(0, 1), norm scales 1, biases 0; each Selfmix as `SelfmixLayer.init`
        (drawn when built), its channel mix scaled by `SELFMIX_SCALE`: the
        layer acts on the unnormalised residual stream, and its quadratic
        term at full scale grows without bound over 12 blocks."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if ".selfmix." in name:
                if leaf == "mix":
                    p.mul_(SELFMIX_SCALE)
                continue
            if leaf == "sln_affine" or ("ln" in leaf and leaf.endswith("_w")):
                p.fill_(1.0)
            elif leaf.endswith(("_b", "_b1", "_b2", "_b3")):
                p.zero_()
            else:
                fan_in = (1 if leaf.endswith("embedding")
                          else p.shape[-1] if leaf == "alpha_dot" else p.shape[-2])
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))

    def serve_chain_keys(self, slot_atoms: list) -> list:
        """The chain keys the serve engine measures at warmup, one per
        bucket of ``n_slots * max_atoms`` atoms (``slot_atoms``): each
        block's Selfmix chain (L, L) -> L on atoms x channels rows, its
        operand shared (share (0, 0)), ungated.  None unless
        chain_tune='measure'."""
        c = self.cfg
        if c.chain_tune != "measure":
            return []
        return [((c.L, c.L), c.L, dict(batch_hint=a * c.channels, share_hint=(0, 0),
                                        dtype="float32", gate=False))
                for a in slot_atoms]

    def _geometry(self, species: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor) -> dict:
        """What every block reads of the edges: sources, validity, the
        edge-frame rotation, the Gaussian distances, the element pairs and
        the grids."""
        c = self.cfg
        S, n = pos.shape[:2]
        nbr, valid = neighbor_graph(pos, mask, c.cutoff, c.max_neighbors)
        src = nbr + (torch.arange(S, device=pos.device) * n)[:, None, None]
        vec = pos.reshape(S * n, 3)[src] - pos[:, :, None]
        ez = axis_vector(2, vec).expand_as(vec)
        vec = torch.where(valid[..., None], vec, ez)
        dist = torch.linalg.norm(vec, dim=-1)
        W = edge_frame_wigner(wigner_blocks_from_rotmat(c.L, align_rotation(vec / dist[..., None])),
                              c.m_max)
        mu = torch.linspace(0.0, c.cutoff, c.n_gaussians, device=pos.device, dtype=pos.dtype)
        width = c.gaussian_width * c.cutoff / (c.n_gaussians - 1)
        rbf = torch.exp(-0.5 * ((dist[..., None] - mu) / width) ** 2)
        dt, dev = pos.dtype, pos.device
        grids = [to_torch(a, dev, dt) for a in _grids(c.L, c.m_max, c.grid_res)]
        return {"src": src, "valid": valid, "W": W, "rbf": rbf,
                "z_src": species.reshape(S * n)[src],
                "z_dst": species[:, :, None].expand_as(src),
                "edge_grid": grids[:2], "node_grid": grids[2:]}

    def energy_forces_masked(self, species: torch.Tensor, pos: torch.Tensor,
                             mask: torch.Tensor):
        """(energy [S], forces [S, n, 3]) of the atoms selected by ``mask``
        [S, n]: the served evaluation, forward only (forces are the force
        head's output; ghost atoms get none)."""
        c = self.cfg
        S, n = pos.shape[:2]
        with span("graph", pos):
            g = self._geometry(species, pos, mask)
        with span("edge_embed", pos):
            x = torch.cat([self.sphere_embedding[species][..., None],
                           pos.new_zeros(S, n, c.channels, (c.L + 1) ** 2 - 1)], dim=-1)
            x = x + self.edge_degree(g)
        for blk in self.blocks:
            with span("attention", pos):
                x = x + blk.ga(blk.norm_1(x), g)
            with span("ffn", pos):
                x = x + blk.ffn(blk.norm_2(x), g["node_grid"])
            with span("selfmix", pos):
                x = blk.selfmix(x)
        with span("heads", pos):
            xf = self.norm(x)
            e = self.energy_block(xf, g["node_grid"])[..., 0, 0]
            energy = (e * mask).sum(-1) / c.avg_num_nodes
            f = self.force_block(xf, g)[..., 0, 1:4] * mask[..., None]
            forces = torch.stack([f[..., 2], f[..., 0], f[..., 1]], dim=-1)
        return energy, forces

    def energy_forces(self, species: torch.Tensor, pos: torch.Tensor):
        """(energy, forces) of one system [n] / [n, 3] or a batch [S, n] /
        [S, n, 3], every atom real; no gradient is taken."""
        single = pos.dim() == 2
        if single:
            species, pos = species[None], pos[None]
        with torch.no_grad():
            e, f = self.energy_forces_masked(species, pos, pos.new_ones(pos.shape[:2]))
        return (e[0], f[0]) if single else (e, f)
