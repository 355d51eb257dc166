"""The comparison that decides ``correct``: what the timed path produced
against the plain reference of the configuration's family (its
``reference``), each number beside its limit
(``perfbench/limits/<cell>.json``).

Serve cells: a sample, drawn from the seed, of the requests the window
served (the one with the most atoms always in it); the reference
evaluates each molecule once, grouped by atom count.
- ``energy_err``: the largest |E - E_ref| over the sample, over the RMS of
  the reference energies of the sample;
- ``force_err``: the largest |F - F_ref| of any component, over the RMS of
  the reference force components of the sample.

Training cell: the first three steps of the window's own step object,
followed by the reference from the same weights on the same batches
(the family's ``reference_loss`` under `perfbench.plain.adamw_reference`).
- ``loss_err``: the largest |loss - loss_ref| / |loss_ref| of the three;
- ``grad_err``: the worst leaf's gap between the norms of the first
  (clipped) gradient, the program's worked out from its AdamW state after
  one step (mu / (1 - b1)), over the larger of that leaf's reference norm
  and the median leaf's;
- ``update_err``: the same of the parameters' change over the three
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move under Adam by round-off alone).
"""
from __future__ import annotations

import numpy as np
import torch

from .plain import adamw_reference, tf32

__all__ = ["sample_requests", "serve_readings", "train_readings", "verdict", "control_serve",
           "control_train"]

SAMPLE = 128
MOVED = 1e-3


def sample_requests(records: list, seed: int, k: int = SAMPLE) -> list:
    """Up to ``k`` records drawn from the seed, the largest molecule always
    among them."""
    if not records:
        return []
    rng = np.random.default_rng([int(seed), 7])
    idx = set(rng.choice(len(records), size=min(k, len(records)), replace=False).tolist())
    idx.add(int(np.argmax([len(r["species"]) for r in records])))
    return [records[i] for i in sorted(idx)]


def reference_serve(family, cfg: dict, weights: dict, records: list, dtype, device):
    """The reference's (energies, forces) of each record, in order."""
    ref = family.reference(cfg, weights, dtype, device)
    out = [None] * len(records)
    by_n: dict = {}
    for i, r in enumerate(records):
        by_n.setdefault(len(r["species"]), []).append(i)
    for n, idx in by_n.items():
        for lo in range(0, len(idx), 64):
            part = idx[lo:lo + 64]
            sp = torch.as_tensor(np.stack([records[i]["species"] for i in part]), device=device)
            pos = torch.as_tensor(np.stack([records[i]["pos"] for i in part]), device=device)
            e, f = ref.energy_forces(sp, pos)
            e, f = e.double().cpu().numpy(), f.double().cpu().numpy()
            for j, i in enumerate(part):
                out[i] = (e[j], f[j])
    return out


def serve_readings(records: list, refs: list) -> dict:
    """energy_err and force_err of served records against reference pairs."""
    e = np.asarray([r["energy"] for r in records], np.float64)
    er = np.asarray([x[0] for x in refs], np.float64)
    df = max(float(np.abs(np.asarray(r["forces"], np.float64) - x[1]).max())
             for r, x in zip(records, refs))
    fr = np.concatenate([x[1].ravel() for x in refs])
    return {"energy_err": float(np.abs(e - er).max() / np.sqrt(np.mean(er ** 2))),
            "force_err": df / float(np.sqrt(np.mean(fr ** 2)))}


def _norm_gap(got: dict, want: dict, names) -> float:
    norms_w = {k: float(want[k].double().norm()) for k in names}
    med = float(np.median(list(norms_w.values())))
    return max(abs(float(got[k].double().norm()) - norms_w[k]) / max(norms_w[k], med)
               for k in names)


def train_readings(prog: dict, ref: dict) -> dict:
    """loss_err, grad_err, update_err of a run ``prog`` against ``ref``,
    each {losses [3], grad {leaf: first clipped gradient}, delta {leaf:
    change over the three steps}}."""
    lp, lr = np.asarray(prog["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    g_norm = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    med = float(np.median(list(g_norm.values())))
    moved = [k for k, v in g_norm.items() if v >= MOVED * med]
    return {"loss_err": float(np.max(np.abs(lp - lr) / np.abs(lr))),
            "grad_err": _norm_gap(prog["grad"], ref["grad"], list(ref["grad"])),
            "update_err": _norm_gap(prog["delta"], ref["delta"], moved)}


def reference_train(family, cfg: dict, weights: dict, batches: list, opt: dict, mix: dict,
                    dtype, device) -> dict:
    """The reference's {losses, grad, delta} over ``batches``."""
    ref = family.reference(cfg, weights, dtype, device)
    w0 = ref.params()
    losses, first, after = adamw_reference(
        w0, lambda batch, w: family.reference_loss(ref, batch, w, mix), batches, opt)
    return {"losses": losses, "grad": first, "delta": {k: after[k] - w0[k] for k in after}}


def verdict(readings: dict, limits: dict) -> bool:
    """Every number within its limit (and a number at all)."""
    return all(np.isfinite(readings.get(k, np.nan)) and readings[k] <= v
               for k, v in limits.items())


def control_serve(family, cfg: dict, weights: dict, records: list, device) -> dict:
    """The control's readings: the reference in float32 with TF32 products
    in the program's place, against the reference in float64."""
    ref = reference_serve(family, cfg, weights, records, torch.float64, device)
    with tf32(True):
        low = reference_serve(family, cfg, weights, records, torch.float32, device)
    served = [{"species": r["species"], "energy": e, "forces": f} for r, (e, f) in zip(records, low)]
    return serve_readings(served, ref)


def control_train(family, cfg: dict, weights: dict, batches: list, opt: dict, mix: dict,
                  device) -> dict:
    """{"tf32": the control's readings, "half_batch": those of the
    reference fed half of each batch (a fault)}, against the reference in
    float64."""
    ref = reference_train(family, cfg, weights, batches, opt, mix, torch.float64, device)
    with tf32(True):
        low = reference_train(family, cfg, weights, batches, opt, mix, torch.float32, device)
    half = [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]
    halfb = reference_train(family, cfg, weights, half, opt, mix, torch.float64, device)
    return {"tf32": train_readings(low, ref), "half_batch": train_readings(halfb, ref)}
