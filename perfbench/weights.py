"""The benchmark's weights: made from the seed on the device, in one draw.

The names and shapes are those of the force field's parameters; both the
program and the reference are handed the same tensors.  Each leaf is
normal with the standard deviation (and mean) the configuration's
``init`` gives for its name, so that energies and forces are of order one.
"""
from __future__ import annotations

import torch

__all__ = ["shapes", "make"]


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


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def make(m: dict, init: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device``: one normal draw from a
    generator on the device seeded with ``seed``, cut into the leaves and
    scaled by ``init[leaf]`` = {"std": s, "mean": mu}."""
    sh = shapes(m)
    sizes = [int(torch.Size(s).numel()) for s in sh.values()]
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, s), part in zip(sh.items(), torch.split(flat, sizes)):
        spec = init[_leaf(name)]
        out[name] = part.reshape(s) * spec["std"] + spec.get("mean", 0.0)
    return out
