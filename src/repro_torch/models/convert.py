"""Convert reference (JAX) parameters into the port's: the state dicts of
MaceGaunt, SegnnNBody and SelfmixLayer, MaceGaunt's optimizer state, and
the language model's parameter tree.

``jax.random`` and torch generators give different numbers from one seed,
so parity runs convert the reference's ``init`` pytrees (as numpy
arrays) instead of re-initialising.  Nothing here imports JAX: the caller
hands over plain arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "segnn_params_from_jax", "selfmix_params_from_jax",
           "opt_state_from_jax", "lm_params_from_jax"]


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


def segnn_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference SegnnNBody pytree {embed, out, layers[{radial{w1,w2}, mix,
    self_mix, gate{w1,w2}}]} -> ``SegnnNBody.load_state_dict`` input."""
    sd = {"embed": _t(tree["embed"]), "out": _t(tree["out"])}
    for i, lp in enumerate(tree["layers"]):
        p = f"layers.{i}."
        sd[p + "radial_w1"] = _t(lp["radial"]["w1"])
        sd[p + "radial_w2"] = _t(lp["radial"]["w2"])
        sd[p + "mix"] = _t(lp["mix"])
        sd[p + "self_mix"] = _t(lp["self_mix"])
        sd[p + "gate_w1"] = _t(lp["gate"]["w1"])
        sd[p + "gate_w2"] = _t(lp["gate"]["w2"])
    return sd


def selfmix_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference SelfmixLayer pytree {w1, w2, w3, mix} ->
    ``SelfmixLayer.load_state_dict`` input."""
    return {k: _t(tree[k]) for k in ("w1", "w2", "w3", "mix")}


def opt_state_from_jax(state: dict) -> dict:
    """Reference optimizer state of a MaceGaunt ({mu, nu, step} of AdamW,
    {mu, step} of Lion or SGD; numpy leaves) -> the port's optimizer state
    (`repro_torch.optim`), each moment tree mapped as `params_from_jax`
    maps the parameters."""
    out = {k: params_from_jax(state[k]) for k in ("mu", "nu") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)
    return out


def _tree_t(tree, layer: int | None = None):
    """numpy tree -> torch tree; with ``layer``, that slice of axis 0."""
    if isinstance(tree, dict):
        return {k: _tree_t(v, layer) for k, v in tree.items()}
    return _t(tree if layer is None else np.asarray(tree)[layer])


def _n_stacked(tree) -> int:
    """Length of axis 0 of a stacked tree's leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree)


_STACKED = ("layers", "enc_layers", "mamba")


def lm_params_from_jax(tree: dict) -> dict:
    """Reference ``init_params`` tree (numpy leaves) -> the port's
    parameters: the same names, with each stacked per-layer tree ("layers";
    "enc_layers" for encdec; "mamba" for hybrid; stacked on axis 0) a list
    of per-layer trees (a MoE layer's experts stay stacked on their own
    axis); the rest ("shared", "cat_proj", "dec_pos", ...) as they are."""
    return {k: ([_tree_t(v, i) for i in range(_n_stacked(v))] if k in _STACKED
                else _tree_t(v)) for k, v in tree.items()}
