"""The MoE near-tie rules of the port's bf16 checks: record the router of
`repro_torch.models.moe`, bound the router margins that bf16 rounding can
overturn, and find the tokens whose expert picks two runs make differently.

A MoE's top-k pick is a discontinuous function of the router's input: where
the k-th and (k+1)-th experts are nearly tied, the rounding of a bf16 run
can swap them, and that token and every later one of its row (through
attention) then part from another run by far more than rounding.  Two rules
excuse such a token:

- `near_tie_bound` (one run): some layer's margin p_(k) - p_(k+1), at the
  token or earlier in its row, is under what rounding the router's bf16
  input can move (u = 2^-8 at the input's scale);
- `pick_flips` (two recorded runs): the two runs really picked different
  experts at some layer, at the token or earlier in its row, and that flip's
  margin is under what the two runs' measured router-input difference can
  move.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["U_BF16", "U_F32", "near_tie_bound", "RouterCall", "RouterLog", "pick_flips"]

U_BF16 = 2.0 ** -8   # bf16's unit roundoff (8-bit significand)
U_F32 = 2.0 ** -24   # float32's


def near_tie_bound(x, w, probs, k: int):
    """The largest router margin p_(k) - p_(k+1) that rounding the router's
    input to bf16 can overturn, per row of ``x`` [..., d].

    The logit gap g = z_(k) - z_(k+1) = sum_i x_i (w_i,e(k) - w_i,e(k+1))
    decides between the k-th and (k+1)-th experts, and p_(k) / p_(k+1) =
    e^g.  At bf16 compute the router's input x is a bf16 tensor: rounding
    it moves each x_i by at most u |x_i|, u = 2^-8, so g moves by at most
    u sum_i |x_i| |w_i,e(k) - w_i,e(k+1)| (the router's input scale).  Two
    runs each round their own x, from f32 sums that differ in the last
    bits, so their gaps may differ by eps = 2 u sum_i |x_i| |dw_i| with no
    fault in either; the picks can swap only where g <= eps, that is where
    the margin p_(k+1) (e^g - 1) <= p_(k+1) (e^eps - 1).
    -> (margin, bound), each [...]."""
    top = probs.argsort(-1, descending=True)
    pk = probs.gather(-1, top[..., k - 1:k])[..., 0]
    pk1 = probs.gather(-1, top[..., k:k + 1])[..., 0]
    dw = w.T[top[..., k - 1]] - w.T[top[..., k]]            # [..., d]
    eps = 2 * U_BF16 * (x.float().abs() * dw.abs()).sum(-1)
    return pk - pk1, pk1 * torch.expm1(eps)


class RouterCall(NamedTuple):
    """One router call: its input x [B, T, d], weight w [d, E], the
    probabilities [B, T, E] and k."""
    x: torch.Tensor
    w: torch.Tensor
    probs: torch.Tensor
    k: int


class RouterLog:
    """Records each call of the port's MoE router
    (`repro_torch.models.moe._route`), one a layer, in call order.  Open it
    as a context manager, or install ``log.wrap(moe._route)`` in its place
    yourself (pytest's ``monkeypatch``)."""

    def __init__(self, calls=None):
        self.calls = list(calls or [])

    def wrap(self, route):
        def recorded(p, x2d, k):
            out = route(p, x2d, k)
            self.calls.append(RouterCall(x2d.detach(), p["router"]["w"].detach(),
                                         out[0].detach(), k))
            return out

        return recorded

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe._route
        moe._route = self.wrap(self._route)
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route

    @classmethod
    def sequence(cls, prefill: "RouterLog", steps: "RouterLog") -> "RouterLog":
        """The calls of a prefill followed by decode steps as one run: per
        layer, the prefill's positions and then each step's one, joined
        along the position axis."""
        n = len(prefill.calls)
        assert len(steps.calls) % n == 0, (len(steps.calls), n)
        out = []
        for layer, c in enumerate(prefill.calls):
            later = steps.calls[layer::n]
            out.append(RouterCall(torch.cat([c.x] + [s.x for s in later], dim=1), c.w,
                                  torch.cat([c.probs] + [s.probs for s in later], dim=1),
                                  c.k))
        return cls(out)

    def margins(self):
        """(margin, bound) of `near_tie_bound` per call, [B, T] each."""
        return [near_tie_bound(c.x, c.w, c.probs, c.k) for c in self.calls]

    def near(self):
        """[B, T] bool: some layer's margin under its bound at (b, t)."""
        return torch.stack([m <= b for m, b in self.margins()]).any(0)

    def nearest(self, b: int, t: int) -> str:
        """The near tie closest before (b, t) in its row: the latest near
        position at or before t, at the layer whose margin is the smallest
        share of its bound there."""
        mb = self.margins()
        m = torch.stack([m[b, :t + 1] for m, _ in mb])
        bd = torch.stack([bd[b, :t + 1] for _, bd in mb])
        pos = int(torch.nonzero((m <= bd).any(0)).max())
        layer = int((m[:, pos] / bd[:, pos]).argmin())
        return (f"layer {layer} position {pos}: margin {float(m[layer, pos]):.3e}, "
                f"bound {float(bd[layer, pos]):.3e}")


def pick_flips(a: RouterLog, b: RouterLog):
    """Where two recorded runs of the same weights pick different top-k
    expert sets, and whether the runs' measured router-input difference
    explains each such flip.

    At a flip some expert e is in a's set and not in b's, and some f in b's
    and not in a's; take e the lowest of a's that b dropped and f the
    highest of b's that a lacks, so the gap g = z_e - z_f >= 0 in a and
    < 0 in b.  The router computes z = x w in float32 from the same weight,
    so g moves between the runs by at most sum_i |xa_i - xb_i| |w_ie - w_if|
    plus each run's float32 product error, d u32 sum_i |x_i| (|w_ie| +
    |w_if|) (u32 = 2^-24).  A correct router can flip only where g is under
    that delta, that is where a's margin p_e - p_f <= p_f (e^delta - 1).
    -> (flip, margin, bound), each [L, B, T] over the positions both runs
    have (a's margin and bound; 0 where no flip)."""
    assert len(a.calls) == len(b.calls), (len(a.calls), len(b.calls))
    flips, margins, bounds = [], [], []
    for ca, cb in zip(a.calls, b.calls):
        T = min(ca.x.shape[1], cb.x.shape[1])
        xa, xb = ca.x[:, :T].float(), cb.x[:, :T].float()
        pa, pb = ca.probs[:, :T], cb.probs[:, :T]
        ina = torch.zeros_like(pa, dtype=torch.bool).scatter_(-1, pa.topk(ca.k, -1).indices, True)
        inb = torch.zeros_like(pb, dtype=torch.bool).scatter_(-1, pb.topk(cb.k, -1).indices, True)
        flip = (ina != inb).any(-1)
        inf = torch.tensor(float("inf"), device=pa.device)
        e = torch.where(ina & ~inb, pa, inf).argmin(-1)
        f = torch.where(inb & ~ina, pa, -inf).argmax(-1)
        we, wf = ca.w.T[e], ca.w.T[f]                         # [B, T, d]
        delta = ((xa - xb).abs() * (we - wf).abs()).sum(-1)
        delta += xa.shape[-1] * U_F32 * ((xa.abs() + xb.abs()) * (we.abs() + wf.abs())).sum(-1)
        p_e, p_f = pa.gather(-1, e[..., None])[..., 0], pa.gather(-1, f[..., None])[..., 0]
        zero = torch.zeros_like(p_e)
        flips.append(flip)
        margins.append(torch.where(flip, p_e - p_f, zero))
        bounds.append(torch.where(flip, p_f * torch.expm1(delta), zero))
    return torch.stack(flips), torch.stack(margins), torch.stack(bounds)
