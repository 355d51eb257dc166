"""The benchmark's plain reference: MACE-Gaunt in plain PyTorch.

It computes the function that the port's ``MaceGaunt`` computes, from its
definition and nothing of the port: no module of ``repro_torch``, no
kernel, no plan, no constant table.  Its own pieces:

- real spherical harmonics as polynomials of the unit vector (associated
  Legendre recurrence), orthonormal on the sphere;
- Gaunt coefficients G[a, b, c] = integral of Y_a Y_b Y_c over the sphere,
  from a product quadrature (Gauss-Legendre in cos(theta), uniform in phi)
  that is exact for the degree of the integrand;
- the model: dense pairwise edges under the cutoff, a Bessel radial basis
  with a cosine envelope, per layer the equivariant conv m_i = sum_j
  Gaunt(h_ij . x_j, Y(r_ij)) truncated at L, a degree-wise channel mix with
  a residual, the nu-fold self-product B = Gaunt(w_1 . A, ..., w_nu . A)
  truncated at L, the gate (scalars gate the higher degrees) before
  ``mb_mix`` when ``grid_gate`` is 'on' (after it when 'off'), and a
  per-atom readout of the invariant channels summed into the energy;
- forces -dE/dpos and the training loss's gradients by autograd (AdamW
  over them is `perfbench.plain.adamw_reference`, shared by every family).

The function is basis independent: the conv's filter sum_m Y_lm(r) Y_lm(u)
is the zonal function (2l+1)/(4 pi) P_l(r.u), and every other operation
acts on whole degrees, so the energy and forces do not depend on the sign
or order convention of the real harmonics within a degree.  Only the
degree-major layout [(L+1)^2] with l = 0 first is shared with the port.

Precision: the reference runs in float64 (``dtype``).  Its control runs it
in float32 with TF32 matrix products (`perfbench.plain.tf32`), the nearest
precision below the port's float32 with TF32 off.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["real_sh", "quadrature", "gaunt", "Reference"]


def real_sh(L: int, v: torch.Tensor) -> torch.Tensor:
    """Real orthonormal spherical harmonics of unit vectors v [..., 3] ->
    [..., (L+1)^2], degree-major (index l*l + l + m, m = -l..l)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    # c_m + i s_m = (x + i y)^m
    cs = [(torch.ones_like(x), torch.zeros_like(x))]
    for _ in range(L):
        c, s = cs[-1]
        cs.append((c * x - s * y, s * x + c * y))
    # Pbar[l][m] = P_l^m(z) / (1 - z^2)^(m/2), a polynomial in z
    pb = [[None] * (L + 1) for _ in range(L + 1)]
    for m in range(L + 1):
        pb[m][m] = torch.full_like(z, float(np.prod(np.arange(1, 2 * m, 2)) if m else 1.0))
        if m + 1 <= L:
            pb[m + 1][m] = (2 * m + 1) * z * pb[m][m]
        for l in range(m + 2, L + 1):
            pb[l][m] = ((2 * l - 1) * z * pb[l - 1][m] - (l + m - 1) * pb[l - 2][m]) / (l - m)
    out = []
    for l in range(L + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am) / math.factorial(l + am))
            if m == 0:
                out.append(norm * pb[l][0])
            else:
                trig = cs[am][0] if m > 0 else cs[am][1]
                out.append(math.sqrt(2.0) * norm * pb[l][am] * trig)
    return torch.stack(out, dim=-1)


def quadrature(degree: int):
    """(points [Q, 3], weights [Q]) float64, exact for spherical
    polynomials up to ``degree``: Gauss-Legendre in cos(theta) with
    degree // 2 + 1 nodes, degree + 1 uniform angles in phi."""
    zt, wt = np.polynomial.legendre.leggauss(degree // 2 + 1)
    n_phi = degree + 1
    phi = 2 * np.pi * np.arange(n_phi) / n_phi
    st = np.sqrt(1 - zt ** 2)
    pts = np.stack([np.outer(st, np.cos(phi)), np.outer(st, np.sin(phi)),
                    np.outer(zt, np.ones(n_phi))], -1).reshape(-1, 3)
    w = np.outer(wt, np.full(n_phi, 2 * np.pi / n_phi)).reshape(-1)
    return pts, w


def gaunt(La: int, Lb: int, Lc: int) -> np.ndarray:
    """G[a, b, c] = integral of Y_a Y_b Y_c over the sphere, float64
    [(La+1)^2, (Lb+1)^2, (Lc+1)^2]."""
    pts, w = quadrature(La + Lb + Lc)
    p = torch.from_numpy(pts)
    Ya, Yb, Yc = (real_sh(L, p).numpy() for L in (La, Lb, Lc))
    return np.einsum("q,qa,qb,qc->abc", w, Ya, Yb, Yc)


def _degrees(L: int) -> np.ndarray:
    """The degree of each packed coefficient."""
    return np.concatenate([np.full(2 * l + 1, l) for l in range(L + 1)])


class Reference:
    """MACE-Gaunt at the sizes of ``model`` (the configuration's ``model``
    dict: L, L_edge, channels, n_layers, nu, n_species, cutoff, n_radial,
    hidden, grid_gate) on ``weights`` (name -> tensor, the names of
    `perfbench.families.mace.shapes`), at ``dtype`` on ``device``."""

    def __init__(self, model: dict, weights: dict, dtype=torch.float64, device="cpu"):
        self.m = model
        self.dtype, self.device = dtype, torch.device(device)
        self.w = {k: v.detach().to(self.device, dtype) for k, v in weights.items()}
        L, Le, nu = model["L"], model["L_edge"], model["nu"]
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)  # noqa: E731
        self.G_conv = t(gaunt(L, Le, L))
        # the nu-fold product left to right, every partial product whole
        self.G_chain = [t(gaunt(k * L, L, (k + 1) * L if k + 1 < nu else L))
                        for k in range(1, nu)]
        self.deg = torch.as_tensor(_degrees(L), device=self.device)

    def params(self) -> dict:
        return self.w

    # ----------------------------------------------------------------- model
    def _gate(self, p, x):
        s = x[..., 0]
        g = torch.sigmoid(F.silu(s @ p["w1"]) @ p["w2"])
        return torch.cat([F.silu(s)[..., None], x[..., 1:] * g[..., None]], dim=-1)

    def _mix(self, W, x):
        """Degree-wise channel mix: x [..., C, k] @ W[l(k)] -> [..., C', k]."""
        return torch.einsum("...ck,kcd->...dk", x, W[self.deg])

    def atom_energies(self, species: torch.Tensor, pos: torch.Tensor, w: dict | None = None):
        """species [S, n] int, pos [S, n, 3] -> per-atom energies [S, n]."""
        m, w = self.m, (self.w if w is None else w)
        L, C, cutoff = m["L"], m["channels"], m["cutoff"]
        S, n = pos.shape[:2]
        dim = (L + 1) ** 2
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        diff = pos[:, None, :, :] - pos[:, :, None, :]            # [S, i, j, 3] = r_j - r_i
        dist = torch.sqrt((diff ** 2).sum(-1) + eye)              # 1 on the diagonal
        mask = (~eye) & (dist < cutoff)
        rhat = diff / dist[..., None]
        ez = torch.zeros(3, dtype=pos.dtype, device=pos.device)
        ez[2] = 1.0
        rhat = torch.where(mask[..., None], rhat, ez)
        maskf = mask.to(pos.dtype)
        # Bessel radial basis, smooth cosine cutoff
        k = torch.arange(1, m["n_radial"] + 1, dtype=pos.dtype, device=pos.device) * math.pi / cutoff
        env = torch.where(dist < cutoff, 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0),
                          torch.zeros_like(dist))
        rb = torch.sin(k * dist[..., None]) / dist[..., None] * env[..., None]
        # conv filter contracted with the Gaunt tensor once per edge: [S, i, j, a, k]
        T = torch.einsum("sijb,abk->sijak", real_sh(m["L_edge"], rhat) * maskf[..., None],
                         self.G_conv)
        x = torch.cat([w["species"][species.long()][..., None],
                       pos.new_zeros(S, n, C, dim - 1)], dim=-1)
        for i in range(m["n_layers"]):
            p = lambda name: w[f"layers.{i}.{name}"]  # noqa: E731
            h = (F.silu(rb @ p("radial_w1")) @ p("radial_w2")).reshape(S, n, n, C, L + 1)
            xw = x[:, None] * h[..., self.deg]                    # [S, i, j, C, a]
            msg = torch.einsum("sijca,sijak->sick", xw, T)
            A = self._mix(p("mix"), msg) + x
            ops = [A * p("mb_w")[k][self.deg] for k in range(m["nu"])]
            B = ops[0]
            for G, o in zip(self.G_chain, ops[1:]):
                B = torch.einsum("...a,...b,abc->...c", B, o, G)
            gate = {"w1": p("gate_w1"), "w2": p("gate_w2")}
            if m["grid_gate"] == "on":
                x = x + self._mix(p("mb_mix"), self._gate(gate, B))
            else:
                x = x + self._gate(gate, self._mix(p("mb_mix"), B))
        feat = x[..., 0]
        return (F.silu(feat @ w["readout_w1"]) @ w["readout_w2"])[..., 0]

    def energy(self, species, pos, w=None):
        return self.atom_energies(species, pos, w).sum(-1)

    def energy_forces(self, species, pos):
        """Energies [S] and forces [S, n, 3] of molecules of one size."""
        pos = pos.to(self.device, self.dtype).detach().requires_grad_(True)
        e = self.energy(species.to(self.device), pos)
        (g,) = torch.autograd.grad(e.sum(), pos)
        return e.detach(), -g

    def loss(self, batch: dict, w: dict, w_e: float, w_f: float) -> torch.Tensor:
        """mean_S( w_e (E - E_ref)^2 + w_f mean((F - F_ref)^2) ), the forces
        kept in the graph."""
        pos = batch["pos"].to(self.device, self.dtype).detach().requires_grad_(True)
        e = self.energy(batch["species"].to(self.device), pos, w)
        (g,) = torch.autograd.grad(e.sum(), pos, create_graph=True)
        de = (e - batch["energy"].to(self.device, self.dtype)) ** 2
        df = ((-g - batch["forces"].to(self.device, self.dtype)) ** 2).mean(dim=(-2, -1))
        return (w_e * de + w_f * df).mean()
