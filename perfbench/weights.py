"""The benchmark's weights: made from the seed on the device, in one draw.

A family gives its parameters' names and shapes; both the program and the
reference are handed the same tensors.  Each leaf is normal with the
standard deviation (and mean) the configuration's ``init`` gives for its
name (the part after the last dot), so that the outputs are of order one.
"""
from __future__ import annotations

import torch

__all__ = ["draw"]


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def draw(shapes: dict, init: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for each name -> shape of
    ``shapes``: one normal draw from a generator on the device seeded with
    ``seed``, cut into the leaves in order and scaled by ``init[leaf]`` =
    {"std": s, "mean": mu}."""
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, s), part in zip(shapes.items(), torch.split(flat, sizes)):
        spec = init[_leaf(name)]
        out[name] = part.reshape(s) * spec["std"] + spec.get("mean", 0.0)
    return out
