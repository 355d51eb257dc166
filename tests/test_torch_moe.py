"""The port's mixture of experts (`repro_torch.models.moe`) against the JAX
reference's on the same parameters and inputs: the capacity, the router's
top-k picks, the per-row sort-based dispatch with its drops, the expert
outputs and the Switch aux loss at the f32 identity tier (3e-4,
scale-relative; bf16 compute at 5e-2), the dense mixture when nothing
drops, and the reference's two dispatch tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.testing import assert_close
from repro_torch.models import moe


def _params(d, E, ff, n_shared, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), d, E, ff, n_shared, "swiglu")
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _kept(gate_idx: np.ndarray, E: int, C: int) -> int:
    """(token, choice) entries within capacity, per row: min(load, C) summed."""
    return sum(int(np.minimum(np.bincount(row.ravel(), minlength=E), C).sum())
               for row in gate_idx)


def test_capacity_matches_reference():
    for T in (1, 7, 24, 64, 256, 2048):
        for E, k in ((4, 2), (16, 4), (60, 4)):
            for cf in (0.5, 1.25, 8.0):
                assert moe.moe_capacity(T, E, k, cf) == jmoe.moe_capacity(T, E, k, cf)


def test_router_picks_match_reference():
    jp, p = _params(32, 8, 64, 0)
    x = _x((2, 16, 32), 1)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    jvals, jidx = jax.lax.top_k(probs, 2)
    tp, vals, idx = moe._route(p, torch.from_numpy(x), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert_close(tp.numpy(), np.asarray(probs))
    assert_close(vals.numpy(), np.asarray(jvals / jvals.sum(-1, keepdims=True)))


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
@pytest.mark.parametrize("n_shared,act", [(0, "swiglu"), (1, "swiglu"), (0, "gelu_mlp")])
def test_moe_apply_matches_reference(cf, n_shared, act):
    """Same params and inputs: the outputs (which entries drop decides them)
    and the aux loss; at cf 0.5 entries drop, at 8.0 none does."""
    d, E, k, ff = 32, 8, 2, 64
    jp, p = _params(d, E, ff, n_shared, seed=2)
    x = _x((2, 64, d), 3)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), E, k, cf, act)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), E, k, cf, act)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want))
    assert_close(aux.numpy(), np.asarray(jaux))
    _, _, idx = moe._route(p, torch.from_numpy(x), k)
    C = moe.moe_capacity(64, E, k, cf)
    dropped = 2 * 64 * k - _kept(idx.numpy(), E, C)
    assert dropped > 0 if cf == 0.5 else cf == 1.25 or dropped == 0


def test_moe_apply_bf16_matches_reference():
    d, E, k, ff = 32, 8, 2, 64
    jp, p = _params(d, E, ff, 1, seed=4)
    x = _x((2, 16, d), 5)
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), E, k, 1.25, "swiglu",
                             jnp.bfloat16)
    got, _ = moe.moe_apply(p, torch.from_numpy(x).bfloat16(), E, k, 1.25, "swiglu",
                           torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype="bfloat16")


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_dispatch_matches_dense_reference(n_shared):
    """The twin of test_arch_smoke.py's: with a capacity nothing exceeds, the
    dispatch equals the dense mixture (the port's and the reference's)."""
    d, E, k, ff = 32, 8, 2, 64
    jp, p = _params(d, E, ff, n_shared, seed=2)
    x = _x((2, 16, d), 3)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), E, k, cf=8.0)
    ref = moe.moe_dense_reference(p, torch.from_numpy(x), E, k)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
    assert_close(ref.numpy(), np.asarray(jmoe.moe_dense_reference(jp, jnp.asarray(x), E, k)))
    assert float(aux) > 0


def test_moe_capacity_drops_are_bounded():
    """The twin of test_arch_smoke.py's: forced drops (cf 0.5) stay finite.
    An entry is kept iff fewer than C earlier entries (in token order) chose
    its expert: a token whose every choice drops gets zero, and a token whose
    every choice is kept gets exactly the dense mixture."""
    d, E, k, ff = 16, 4, 2, 32
    _, p = _params(d, E, ff, 0, seed=4)
    x = torch.from_numpy(_x((1, 64, d), 5))
    y, _ = moe.moe_apply(p, x, E, k, cf=0.5)
    assert bool(torch.isfinite(y).all())
    _, _, idx = moe._route(p, x, k)
    C = moe.moe_capacity(64, E, k, 0.5)
    flat = idx[0].reshape(-1).numpy()
    kept = np.array([(flat[:i] == e).sum() < C for i, e in enumerate(flat)]).reshape(64, k)
    assert kept.sum() == _kept(idx.numpy(), E, C) < 64 * k
    none, every = ~kept.any(1), kept.all(1)
    assert none.any() and every.any()
    assert float(y[0, torch.from_numpy(none)].abs().max()) == 0.0
    dense = moe.moe_dense_reference(p, x, E, k)
    np.testing.assert_allclose(y[0, torch.from_numpy(every)].numpy(),
                               dense[0, torch.from_numpy(every)].numpy(), atol=1e-5, rtol=1e-5)
