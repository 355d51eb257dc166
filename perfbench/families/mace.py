"""The MACE-Gaunt family: the force field of the MACE 3BPA configurations.

Everything the run kinds call for a configuration whose ``family`` is
``mace``:

- `shapes`, `make_weights`: its parameters, drawn from the seed
  (`perfbench.weights.draw`) at the stds of the configuration's ``init``;
- `build`: the port's ``MaceGaunt`` at the configuration's ``model``;
- `reference`, `reference_loss`: the plain reference
  (`perfbench.reference.Reference`: float64, plain PyTorch, nothing of the
  port) and its energy-and-force loss;
- `molecules` (serving), `batches` and `loss` (training): Lennard-Jones
  clusters from the seed (`perfbench.lj`), and the port's loss on them;
- `serve_flops`, `train_flops`: model FLOPs (`perfbench.work`);
- `kernel_bounds`: the least time of the chain kernel's calls in a traced
  window.

The port is imported inside `build` alone, so the reference and the
inputs load nothing of it.
"""
from __future__ import annotations

import numpy as np

from perfbench import weights, work
from perfbench.lj import lj_dataset
from perfbench.reference import Reference

__all__ = ["shapes", "make_weights", "build", "reference", "reference_loss", "molecules",
           "batches", "loss", "serve_flops", "train_flops", "kernel_bounds"]


def shapes(m: dict) -> dict:
    """name -> shape of every parameter of the force field at sizes ``m``."""
    C, L, R, H = m["channels"], m["L"], m["n_radial"], m["hidden"]
    out = {"species": (m["n_species"], C), "readout_w1": (C, H), "readout_w2": (H, 1)}
    for i in range(m["n_layers"]):
        out.update({f"layers.{i}.radial_w1": (R, 32),
                    f"layers.{i}.radial_w2": (32, C * (L + 1)),
                    f"layers.{i}.mix": (L + 1, C, C),
                    f"layers.{i}.mb_mix": (L + 1, C, C),
                    f"layers.{i}.mb_w": (m["nu"], L + 1),
                    f"layers.{i}.gate_w1": (C, 32),
                    f"layers.{i}.gate_w2": (32, C)})
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    return weights.draw(shapes(cfg["model"]), cfg["init"], seed, device)


def build(cfg: dict, wts: dict, device):
    """The port's MaceGaunt at the configuration, on ``wts`` (its chain
    picks persist where ``run.py`` points $REPRO_TORCH_AUTOTUNE_CACHE)."""
    from repro_torch.configs.gaunt_ff import EquivariantConfig
    from repro_torch.models.equivariant import MaceGaunt

    ec = EquivariantConfig(name=cfg["name"], kind="mace", **cfg["model"])
    model = MaceGaunt(ec, device=device)
    model.load_state_dict(wts)
    return model


def reference(cfg: dict, wts: dict, dtype, device) -> Reference:
    return Reference(cfg["model"], wts, dtype=dtype, device=device)


def reference_loss(ref: Reference, batch: dict, w: dict, mix: dict):
    return ref.loss(batch, w, mix["w_e"], mix["w_f"])


def molecules(mix: dict, n_atoms: int, count: int, seed: int):
    """(species int64 [count, n_atoms], pos float32 [count, n_atoms, 3]):
    LJ clusters of the mix's species, from the seed and the size."""
    d = lj_dataset(count, n_atoms, mix["species"], seed=[seed, 3, n_atoms])
    return d["species"].astype(np.int64), d["pos"]


def batches(mix: dict, seed: int):
    """i -> the i-th batch (numpy) of the mix's data set, taken in order and
    cycling: ``dataset`` LJ clusters of ``atoms`` atoms from the seed."""
    d = lj_dataset(mix["dataset"], mix["atoms"], mix["species"], seed=[seed, 4])
    d["species"] = d["species"].astype(np.int64)
    B, n = mix["batch"], mix["dataset"] // mix["batch"]

    def batch(i):
        lo = (i % n) * B
        return {k: v[lo:lo + B] for k, v in d.items()}
    return batch


def loss(model, batch: dict, mix: dict):
    """The port's energy-and-force loss (the double backward)."""
    return model.loss(batch, w_e=mix["w_e"], w_f=mix["w_f"])


def serve_flops(cfg: dict, n_atoms: int) -> int:
    """Model FLOPs of one served evaluation of ``n_atoms`` atoms."""
    return work.serve_flops(cfg["model"], n_atoms)


def train_flops(cfg: dict, mix: dict) -> int:
    """Model FLOPs of one training step on a batch of the mix."""
    return mix["batch"] * work.train_flops(cfg["model"], mix["atoms"])


def kernel_bounds(cfg: dict, buckets: list) -> dict:
    """{"gaunt_chain": {bound_s, launches}} over a traced window: each
    bucket ({n_slots, max_atoms, launches a replay, replays}) adds its
    replays times its chain launches a replay, each call on the bucket's
    rows (n_slots x max_atoms x channels)."""
    m = cfg["model"]
    total_s, launches = 0.0, 0
    for b in buckets:
        calls = b["replays"] * b["launches"].get("gaunt_chain", 0)
        rows = b["n_slots"] * b["max_atoms"] * m["channels"]
        f, nbytes = work.chain_work(rows, m["L"], m["nu"], m["L"], gated=True)
        total_s += calls * work.bound_s(f, nbytes)
        launches += calls
    return {"gaunt_chain": {"bound_s": total_s, "launches": launches}}
