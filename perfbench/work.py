"""The yardstick's counts of work and the card's peaks.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s of HBM.  A share of a peak is
stated against these, with the card's power limit printed beside it.

Chain kernel (`gaunt_chain_kernel`).  The function it computes: three
operands x_1, x_2, x_3 [rows, (L+1)^2] (already weighted), their Gaunt
product on the sphere truncated at Lout, gated per row as g * B + beta e0
(gate scalars g, beta [rows]).  Work is counted for that function, not for
the kernel's collocation grid, so a kernel that samples differently is
measured against the same count:

- operations: the exact algorithm with the fewest operations among those
  counted here, the sparse contraction over the nonzeros of the real
  Gaunt tensors, left to right with every partial product whole: for each
  step one product per operand pair (a, b) that has a nonzero, then one
  multiply-add per nonzero; the gate one multiply per output coefficient
  and one add;
- bytes: each input read once (the operands and the gate scalars, float32)
  and the output written once, plus the nonzero Gaunt values once a call.

Model FLOPs.  One function of the configuration's sizes and the molecule's
atom count, the same for the eSCN and the general conv (they compute the
same function): the cheapest exact route the port has, eSCN's, counted as
2 FLOPs a multiply-add over the matrix products and contractions of the
forward pass:

- per edge (n (n - 1) ordered pairs of a molecule, every pair the model
  forms) and layer: the radial MLP (n_radial -> 32 -> C (L+1));
- per edge, channel and layer: the per-degree weights on x, the rotation
  into the edge frame and back (block-diagonal Wigner D, sum (2l+1)^2 a
  degree), the aligned product (for each m a (L+1-|m|) x (L+1-|m|) map,
  the filter's m = 0 column folded in), and the masked sum over
  neighbours;
- per atom and layer: the two channel mixes (C x C a coefficient), the
  chain (the sparse contraction above, and the per-operand weights), the
  gate's MLP (C -> 32 -> C) and its scale;
- per atom: the readout (C -> hidden -> 1).

Elementwise activations, the geometry (distances, the rotations'
construction, the radial basis) and the optimizer are not counted.  The
backward passes are counted from the forward F: a served evaluation (energy
and forces) is F + F (the gradient to the inputs costs one more pass), a
training step (energy, forces, and the gradient of the force loss to the
parameters, a double backward) is 2F + 2 (2F) = 6F.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["PEAK_F32_FLOPS", "PEAK_BYTES", "bound_s", "gaunt_nonzeros", "chain_work",
           "forward_flops", "serve_flops", "train_flops"]

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the f32 peak and bytes over the bandwidth."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


@functools.lru_cache(maxsize=None)
def gaunt_nonzeros(La: int, Lb: int, Lc: int) -> tuple[int, int]:
    """(nonzeros, operand pairs with a nonzero) of the real Gaunt tensor
    [(La+1)^2, (Lb+1)^2, (Lc+1)^2]."""
    from .reference import gaunt

    G = gaunt(La, Lb, Lc)
    nz = np.abs(G) > 1e-9 * np.abs(G).max()
    return int(nz.sum()), int(nz.any(axis=-1).sum())


def _chain_steps(L: int, nu: int, Lout: int):
    """The Gaunt tensors of the left-to-right chain: (k L, L, next)."""
    return [(k * L, L, (k + 1) * L if k + 1 < nu else Lout) for k in range(1, nu)]


def chain_work(rows: int, L: int = 2, nu: int = 3, Lout: int = 2, gated: bool = True):
    """(FLOPs, bytes) of one chain call on ``rows`` rows."""
    dout = (Lout + 1) ** 2
    per_row, consts = 0, 0
    for a, b, c in _chain_steps(L, nu, Lout):
        nnz, pairs = gaunt_nonzeros(a, b, c)
        per_row += pairs + 2 * nnz
        consts += nnz
    if gated:
        per_row += dout + 1
    nbytes = 4 * (rows * (nu * (L + 1) ** 2 + (2 if gated else 0) + dout) + consts)
    return rows * per_row, nbytes


def forward_flops(m: dict, n_atoms: int) -> int:
    """Forward FLOPs of one molecule of ``n_atoms`` atoms at sizes ``m``."""
    L, C, R, H, nu = m["L"], m["channels"], m["n_radial"], m["hidden"], m["nu"]
    dim = (L + 1) ** 2
    edges = n_atoms * (n_atoms - 1)
    radial = 2 * (R * 32 + 32 * C * (L + 1))
    rotate = 2 * sum((2 * l + 1) ** 2 for l in range(L + 1))
    aligned = 2 * sum((L + 1 - abs(mm)) ** 2 for mm in range(-L, L + 1))
    per_edge_channel = dim + 2 * rotate + aligned + 2 * dim
    chain_f, _ = chain_work(1, L, nu, L, gated=True)
    per_atom = (2 * 2 * C * C * dim                     # mix and mb_mix
                + C * (chain_f + nu * dim)              # chain with its weights
                + 2 * (C * 32 + 32 * C) + C * dim)      # gate MLP and scale
    layer = edges * (radial + C * per_edge_channel) + n_atoms * per_atom
    readout = n_atoms * 2 * (C * H + H)
    return m["n_layers"] * layer + readout


def serve_flops(m: dict, n_atoms: int) -> int:
    """One served evaluation: energy and forces."""
    return 2 * forward_flops(m, n_atoms)


def train_flops(m: dict, n_atoms: int) -> int:
    """One molecule's share of a training step (the double backward)."""
    return 6 * forward_flops(m, n_atoms)
