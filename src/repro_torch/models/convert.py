"""Convert reference (JAX) MaceGaunt parameters into the port's state dict.

``jax.random`` and torch generators give different numbers from one seed,
so parity runs convert the reference's ``MaceGaunt.init`` pytree (as numpy
arrays) instead of re-initialising.  Nothing here imports JAX: the caller
hands over plain arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference pytree {species, readout{w1,w2}, layers[{radial{w1,w2}, mix,
    mb_mix, mb_w, gate{w1,w2}}]} -> ``MaceGaunt.load_state_dict`` input."""
    sd = {"species": _t(tree["species"]),
          "readout_w1": _t(tree["readout"]["w1"]),
          "readout_w2": _t(tree["readout"]["w2"])}
    for i, lp in enumerate(tree["layers"]):
        p = f"layers.{i}."
        sd[p + "radial_w1"] = _t(lp["radial"]["w1"])
        sd[p + "radial_w2"] = _t(lp["radial"]["w2"])
        sd[p + "mix"] = _t(lp["mix"])
        sd[p + "mb_mix"] = _t(lp["mb_mix"])
        sd[p + "mb_w"] = _t(lp["mb_w"])
        sd[p + "gate_w1"] = _t(lp["gate"]["w1"])
        sd[p + "gate_w2"] = _t(lp["gate"]["w2"])
    return sd
