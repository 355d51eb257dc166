"""The port's eSCN EquivariantConv (precomputed WignerBlocks and raw
directions) against the reference, forward and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.conv import EquivariantConv as RefConv
from repro.testing import (assert_close, random_angles, random_irreps,
                           random_unit_vectors, rotate_irreps, rotation_matrix)
from repro_torch.core.conv import EquivariantConv, WignerBlocks

L1, L2 = 2, 3


def _data(seed):
    x = random_irreps(L1, (4, 3, 2), seed)
    rhat = random_unit_vectors((4, 3, 1), seed + 1)
    w1 = np.random.default_rng(seed + 2).normal(size=(4, 3, 2, L1 + 1)).astype(np.float32)
    return x, rhat, w1


@pytest.mark.parametrize("Lout", [2, 4])
@pytest.mark.parametrize("resident", [True, False])
def test_escn_conv_matches_reference(Lout, resident):
    x, rhat, w1 = _data(Lout + 10 * resident)
    ref = RefConv(L1, L2, Lout, method="escn")
    rg = ref.geometry_rep(jnp.asarray(rhat)) if resident else jnp.asarray(rhat)
    want = np.asarray(ref(jnp.asarray(x), rg, w1=jnp.asarray(w1)))
    conv = EquivariantConv(L1, L2, Lout)
    tr = torch.as_tensor(rhat)
    g = conv.geometry_rep(tr) if resident else tr
    assert isinstance(g, WignerBlocks) == resident
    got = conv(torch.as_tensor(x), g, w1=torch.as_tensor(w1))
    assert got.shape == want.shape
    assert_close(got.numpy(), want, dtype="float32")


def test_escn_conv_gradients_match_reference():
    """d(sum(out * W))/d(x, rhat) through the hoisted Wigner geometry."""
    x, rhat, w1 = _data(3)
    W = np.random.default_rng(9).normal(size=(4, 3, 2, 9)).astype(np.float32)
    ref = RefConv(L1, L2, L1, method="escn")

    def ref_loss(x, r):
        return jnp.sum(ref(x, ref.geometry_rep(r), w1=jnp.asarray(w1)) * W)

    want = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(rhat))
    conv = EquivariantConv(L1, L2, L1)
    tx = torch.as_tensor(x).requires_grad_(True)
    tr = torch.as_tensor(rhat).requires_grad_(True)
    out = conv(tx, conv.geometry_rep(tr), w1=torch.as_tensor(w1))
    got = torch.autograd.grad((out * torch.as_tensor(W)).sum(), (tx, tr))
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w), dtype="float32", tier="loose")


def test_escn_conv_equivariant():
    """conv(D x, R r) == D conv(x, r) on the port."""
    x, rhat, _ = _data(5)
    ang = random_angles(4)
    R = rotation_matrix(ang)
    conv = EquivariantConv(L1, L2, L1)
    out = conv(torch.as_tensor(x), torch.as_tensor(rhat)).numpy()
    out_rot = conv(torch.as_tensor(rotate_irreps(x, L1, ang).astype(np.float32)),
                   torch.as_tensor((rhat @ R.T).astype(np.float32))).numpy()
    assert_close(out_rot, rotate_irreps(out, L1, ang), dtype="float32", tier="transform")
