"""The plain reference of the EquiformerV2 family: EquiformerV2 with a
Gaunt Selfmix a block, in plain PyTorch.

It computes the function that the port's ``EquiformerV2Gaunt`` computes
(the equations are in that module's docstring: graph, edge frame, edge
scalars, embedding, blocks, heads, grid) from their statement and nothing
of the port: no module of ``repro_torch``, no kernel, plan, graph or
constant table.  Its own pieces, beside `perfbench.reference`'s real
harmonics, quadrature and Gaunt tensor:

- the edge frame: the rotation with rows (b1, b2, u), b1 = t x u / |t x
  u|, t = e_z where |u_x| > 0.9 and e_x elsewhere, b2 = u x b1;
- its Wigner matrices by projection on a quadrature exact for degree 2L:
  D^l_{ab} = sum_q w_q S_a(R p_q) S_b(p_q), so that D S(v) = S(R v);
- the S^2 grid: Gauss-Legendre latitudes by uniform longitudes, the
  harmonics at the points and the quadrature projection, with the
  rescale sqrt((2l+1)/(2M+1)) of degrees l > M on the edge-frame grid;
- the model on dense per-system tensors, a few systems at a time
  (`energy_forces`): a float64 edge grid of 16 x 86 atoms would take 4.6 GB.

Precision: float64 (``dtype``), TF32 off unless the caller switches it on
(`perfbench.plain.tf32`, the control).  The neighbours are chosen from
float64 squared distances of the positions given, whatever ``dtype``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .reference import gaunt, quadrature, real_sh

__all__ = ["EquiformerReference"]

EPS = 1e-5
BLOCK = 4  # systems a pass


def _lm(L: int):
    """(l, m) of each packed coefficient, degree-major."""
    return [(l, m) for l in range(L + 1) for m in range(-l, l + 1)]


def _edge_rows(L: int, M: int) -> list:
    """The packed indices an edge frame keeps, m-primary: m = 0 (l = 0..L),
    then for m = 1..M the +m ones (l = m..L) and the -m ones."""
    rows = [l * l + l for l in range(L + 1)]
    for m in range(1, M + 1):
        rows += [l * l + l + m for l in range(m, L + 1)]
        rows += [l * l + l - m for l in range(m, L + 1)]
    return rows


def _grid(L: int, res: int, M: int | None):
    """(to_grid, from_grid) [res^2, (L+1)^2] float64 numpy."""
    z, w = np.polynomial.legendre.leggauss(res)
    phi = 2 * np.pi * np.arange(res) / res
    pts = []
    weights = []
    for a in range(res):
        s = math.sqrt(max(0.0, 1 - z[a] ** 2))
        for b in range(res):
            pts.append((s * math.cos(phi[b]), s * math.sin(phi[b]), z[a]))
            weights.append(w[a] * 2 * np.pi / res)
    Y = real_sh(L, torch.tensor(pts, dtype=torch.float64)).numpy()
    scale = np.array([math.sqrt((2 * l + 1) / (2 * M + 1)) if M is not None and M < L and l > M
                      else 1.0 for l, _ in _lm(L)])
    return Y * scale, Y * scale * np.asarray(weights)[:, None]


def _frame(u: torch.Tensor) -> torch.Tensor:
    """Rotations [..., 3, 3] taking unit vectors u [..., 3] to e_z."""
    ex = torch.zeros_like(u)
    ex[..., 0] = 1.0
    ez = torch.zeros_like(u)
    ez[..., 2] = 1.0
    t = torch.where((u[..., :1].abs() > 0.9), ez, ex)
    b1 = torch.cross(t, u, dim=-1)
    b1 = b1 / b1.norm(dim=-1, keepdim=True)
    b2 = torch.cross(u, b1, dim=-1)
    return torch.stack([b1, b2, u], dim=-2)


class EquiformerReference:
    """The model at the sizes of ``model`` (the configuration's ``model``
    dict) on ``weights`` (name -> tensor, the names of
    `perfbench.families.equiformer.shapes`), at ``dtype`` on ``device``."""

    def __init__(self, model: dict, weights: dict, dtype=torch.float64, device="cpu"):
        self.m = m = model
        self.dtype, self.device = dtype, torch.device(device)
        self.w = {k: v.detach().to(self.device, dtype) for k, v in weights.items()}
        L, M = m["L"], m["m_max"]
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)  # noqa: E731
        self.rows = _edge_rows(L, M)
        te, fe = _grid(L, m["grid_res"], M)
        self.edge_grid = (t(te[:, self.rows]), t(fe[:, self.rows]))
        self.node_grid = tuple(t(a) for a in _grid(L, m["grid_res"], None))
        pts, qw = quadrature(2 * L)
        self.q_pts, self.q_w = t(pts), t(qw)
        self.q_sh = real_sh(L, self.q_pts)                       # [Q, (L+1)^2]
        self.deg = torch.as_tensor([l for l, _ in _lm(L)], device=self.device)
        self.G = t(gaunt(L, L, L)).reshape(-1, (L + 1) ** 2)     # [(a, b), c]

    def params(self) -> dict:
        return self.w

    # ------------------------------------------------------------- geometry
    def _neighbours(self, pos: torch.Tensor):
        """(sources [S, n, k], valid [S, n, k]): the nearest others under the
        cutoff by float64 squared distance, ties to the lower index."""
        m = self.m
        p = pos.to(torch.float64)
        S, n = p.shape[:2]
        dx = [p[:, None, :, c] - p[:, :, None, c] for c in range(3)]   # [S, i, j]
        d2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
        far = (d2 >= m["cutoff"] ** 2) | torch.eye(n, dtype=torch.bool, device=p.device)
        d2 = d2.masked_fill(far, float("inf"))
        key, order = torch.sort(d2, dim=-1, stable=True)
        k = min(m["max_neighbors"], n)
        return order[..., :k], torch.isfinite(key[..., :k])

    def _wigner_rows(self, R: torch.Tensor) -> torch.Tensor:
        """The frame's rotation on the edge-frame rows: [..., n_edge, (L+1)^2]."""
        Y = real_sh(self.m["L"], torch.einsum("...ij,qj->...qi", R, self.q_pts))
        full = torch.einsum("...qa,q,qb->...ab", Y[..., self.rows], self.q_w, self.q_sh)
        same = (self.deg[self.rows][:, None] == self.deg[None, :]).to(full.dtype)
        return full * same

    # ------------------------------------------------------------- layers
    @staticmethod
    def _radial(w, pre, e):
        h = e
        for i in (1, 2):
            h = h @ w[f"{pre}rad_w{i}"] + w[f"{pre}rad_b{i}"]
            h = F.silu(F.layer_norm(h, h.shape[-1:], w[f"{pre}rad_ln{i}_w"],
                                    w[f"{pre}rad_ln{i}_b"], EPS))
        return h @ w[f"{pre}rad_w3"] + w[f"{pre}rad_b3"]

    def _sln(self, pre, x):
        """x [N, C, (L+1)^2]."""
        w, L = self.w, self.m["L"]
        out = torch.empty_like(x)
        out[..., 0] = F.layer_norm(x[..., 0], x.shape[-2:-1], w[pre + "ln_w"],
                                   w[pre + "ln_b"], EPS)
        s = torch.zeros_like(x[..., 0])
        for l in range(1, L + 1):
            s = s + (x[..., l * l:(l + 1) ** 2] ** 2).mean(-1) / L
        scale = 1.0 / torch.sqrt(s.mean(-1, keepdim=True) + EPS)
        for l in range(1, L + 1):
            out[..., l * l:(l + 1) ** 2] = (x[..., l * l:(l + 1) ** 2]
                                            * (scale * w[pre + "sln_affine"][l - 1])[..., None])
        return out

    def _lin(self, pre, x):
        """Per-degree channel map x [N, C, (L+1)^2] -> [N, C', .] plus a bias on l = 0."""
        w = self.w
        y = torch.einsum("nck,kcd->ndk", x, w[pre + "_w"][self.deg])
        y[..., 0] = y[..., 0] + w[pre + "_b"]
        return y

    def _so2(self, pre, y, c_out, rad=None, n_extra=0):
        """y {m: [E, C_in, n_l]} (m = 0, +1, -1, ...) -> ({m: [E, c_out, n_l]},
        extra scalars)."""
        w, L, M = self.w, self.m["L"], self.m["m_max"]
        E, c_in = y[0].shape[:2]
        r0 = c_in * (L + 1)
        x0 = y[0].reshape(E, -1) * (rad[:, :r0] if rad is not None else 1.0)
        o0 = x0 @ w[f"{pre}_m0_w"] + w[f"{pre}_m0_b"]
        out = {0: o0[:, n_extra:].reshape(E, c_out, L + 1)}
        off = r0
        for m in range(1, M + 1):
            nl = L + 1 - m
            r = rad[:, off:off + c_in * nl] if rad is not None else 1.0
            a_p = (y[m].reshape(E, -1) * r) @ w[f"{pre}_m{m}_w"]
            a_n = (y[-m].reshape(E, -1) * r) @ w[f"{pre}_m{m}_w"]
            h = c_out * nl
            out[m] = (a_p[:, :h] - a_n[:, h:]).reshape(E, c_out, nl)
            out[-m] = (a_n[:, :h] + a_p[:, h:]).reshape(E, c_out, nl)
            off += c_in * nl
        return out, o0[:, :n_extra]

    def _split(self, y):
        """[E, C, n_edge] (m-primary) -> {m: [E, C, n_l]}."""
        L, M = self.m["L"], self.m["m_max"]
        out = {0: y[..., :L + 1]}
        off = L + 1
        for m in range(1, M + 1):
            nl = L + 1 - m
            out[m], out[-m] = y[..., off:off + nl], y[..., off + nl:off + 2 * nl]
            off += 2 * nl
        return out

    def _join(self, d):
        M = self.m["m_max"]
        return torch.cat([d[0]] + [t for m in range(1, M + 1) for t in (d[m], d[-m])], dim=-1)

    def _edge_scalars(self, pre, g):
        w = self.w
        return torch.cat([g["rbf"], w[pre + "source_embedding"][g["zs"]],
                          w[pre + "target_embedding"][g["zt"]]], dim=-1)

    def _attention(self, pre, x, g, c_out):
        """x [N, C, (L+1)^2] -> [N, c_out, (L+1)^2]."""
        w, m = self.w, self.m
        H, A, V, Ha = m["n_heads"], m["attn_alpha"], m["attn_value"], m["attn_hidden"]
        msg = torch.cat([x[g["src"]], x[g["dst"]]], dim=1)             # [E, 2C, (L+1)^2]
        y = torch.einsum("eab,ecb->eca", g["W"], msg)
        rad = self._radial(w, pre, self._edge_scalars(pre, g))
        y, extra = self._so2(pre + "conv1", self._split(y), Ha, rad, H * A + Ha)
        a = extra[:, :H * A].reshape(-1, H, A)
        a = F.layer_norm(a, (A,), w[pre + "alpha_ln_w"], w[pre + "alpha_ln_b"], EPS)
        a = 0.6 * a + 0.4 * a * (2 * torch.sigmoid(a) - 1)
        logit = (a * w[pre + "alpha_dot"]).sum(-1)                      # [E, H]
        N = x.shape[0]
        mx = torch.full((N, H), -math.inf, dtype=x.dtype, device=x.device)
        mx = mx.scatter_reduce(0, g["dst"][:, None].expand(-1, H), logit, "amax")
        ex = torch.exp(logit - mx[g["dst"]])
        den = torch.zeros(N, H, dtype=x.dtype, device=x.device).index_add(0, g["dst"], ex)
        alpha = ex / (den[g["dst"]] + 1e-16)
        to_g, from_g = self.edge_grid
        y = self._join(y)                                               # [E, Ha, n_edge]
        act = torch.einsum("gk,eck->ecg", to_g, y)
        act = torch.einsum("ecg,gk->eck", F.silu(act), from_g)
        act[..., 0] = F.silu(extra[:, H * A:])
        v, _ = self._so2(pre + "conv2", self._split(act), H * V)
        v = self._join(v).reshape(-1, H, V, len(self.rows)) * alpha[..., None, None]
        back = torch.einsum("eca,eab->ecb", v.reshape(-1, H * V, len(self.rows)), g["W"])
        agg = torch.zeros(N, H * V, back.shape[-1], dtype=x.dtype, device=x.device)
        agg = agg.index_add(0, g["dst"], back)
        return self._lin(pre + "proj", agg)

    def _ffn(self, pre, x):
        w = self.w
        gate = F.silu(x[..., 0] @ w[pre + "scalar_w"] + w[pre + "scalar_b"])
        h = self._lin(pre + "lin1", x)
        to_g, from_g = self.node_grid
        p = torch.einsum("gk,nfk->ngf", to_g, h)
        p = F.silu(p @ w[pre + "grid_w1"])
        p = F.silu(p @ w[pre + "grid_w2"])
        p = p @ w[pre + "grid_w3"]
        h = torch.einsum("ngf,gk->nfk", p, from_g)
        h[..., 0] = gate
        return self._lin(pre + "lin2", h)

    def _selfmix(self, pre, x):
        w, L = self.w, self.m["L"]
        a = x * w[pre + "w1"][self.deg]
        b = x * w[pre + "w2"][self.deg]
        N, C, D = x.shape
        y = (a[..., :, None] * b[..., None, :]).reshape(N * C, D * D) @ self.G
        y = y.reshape(N, C, D) * w[pre + "w3"][self.deg]
        return x + torch.einsum("nck,kcd->ndk", y, w[pre + "mix"][self.deg])

    # ------------------------------------------------------------- model
    def _systems(self, species: torch.Tensor, pos: torch.Tensor):
        """Energies [S] and forces [S, n, 3] of systems of one size, every
        atom real."""
        w, m = self.w, self.m
        L, C = m["L"], m["channels"]
        S, n = species.shape
        nbr, valid = self._neighbours(pos)
        p = pos.to(self.dtype)
        # the valid edges as flat lists: target i <- source j
        s_i, i_i, k_i = torch.nonzero(valid, as_tuple=True)
        dst = s_i * n + i_i
        src = s_i * n + nbr[s_i, i_i, k_i]
        pf = p.reshape(S * n, 3)
        vec = pf[src] - pf[dst]
        dist = vec.norm(dim=-1)
        zf = species.reshape(S * n)
        mu = torch.linspace(0.0, m["cutoff"], m["n_gaussians"], dtype=self.dtype,
                            device=self.device)
        sigma = m["gaussian_width"] * m["cutoff"] / (m["n_gaussians"] - 1)
        g = {"src": src, "dst": dst, "zs": zf[src], "zt": zf[dst],
             "rbf": torch.exp(-0.5 * ((dist[:, None] - mu) / sigma) ** 2),
             "W": self._wigner_rows(_frame(vec / dist[:, None]))}
        N = S * n
        x = torch.zeros(N, C, (L + 1) ** 2, dtype=self.dtype, device=self.device)
        x[..., 0] = w["sphere_embedding"][zf]
        m0 = self._radial(w, "edge_degree.", self._edge_scalars("edge_degree.", g))
        m0 = m0.reshape(-1, C, L + 1)
        deg0 = torch.einsum("ecl,elb->ecb", m0, g["W"][:, :L + 1])
        x = x + torch.zeros_like(x).index_add(0, dst, deg0) / m["avg_degree"]
        for b in range(m["n_layers"]):
            pre = f"blocks.{b}."
            x = x + self._attention(pre + "ga.", self._sln(pre + "norm_1.", x), g, C)
            x = x + self._ffn(pre + "ffn.", self._sln(pre + "norm_2.", x))
            x = self._selfmix(pre + "selfmix.", x)
        xf = self._sln("norm.", x)
        e_atom = self._ffn("energy_block.", xf)[:, 0, 0]
        energy = e_atom.reshape(S, n).sum(-1) / m["avg_num_nodes"]
        f = self._attention("force_block.", xf, g, 1)[:, 0, 1:4]       # (y, z, x)
        forces = torch.stack([f[:, 2], f[:, 0], f[:, 1]], dim=-1).reshape(S, n, 3)
        return energy, forces

    def energy_forces(self, species: torch.Tensor, pos: torch.Tensor):
        """Energies [S] and forces [S, n, 3] of systems of one size, computed
        `BLOCK` systems at a time."""
        species, pos = species.to(self.device).long(), pos.to(self.device)
        parts = [self._systems(species[i:i + BLOCK], pos[i:i + BLOCK])
                 for i in range(0, species.shape[0], BLOCK)]
        return torch.cat([e for e, _ in parts]), torch.cat([f for _, f in parts])
