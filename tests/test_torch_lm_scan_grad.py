"""The LM scans' training route against the JAX reference:
`wkv6_hopper_grad` and `mamba2_ssd_hopper_grad` (on the CPU, the plain
scans) and the kernel route's backward (`_plain_backward`) against
jax.grad of the reference's chunked scans, at the reference's kernel-test
shapes (f32 loose tier, 2e-3); on tensors off the CPU the routes reach
the kernel's launch; and the route's autograd inside the model, remat
on, with the kernel's launch stood in for by its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2 import mamba2_ssd_chunked as jmamba2_ssd_chunked
from repro.kernels.wkv6 import wkv6_chunked as jwkv6_chunked
from repro.testing import assert_close
from repro_torch.config import get_config
from repro_torch.kernels.mamba2 import (mamba2_ssd_chunked, mamba2_ssd_hopper,
                                        mamba2_ssd_hopper_grad)
from repro_torch.kernels.wkv6 import (_plain_backward, wkv6_chunked, wkv6_hopper,
                                      wkv6_hopper_grad)
from repro_torch.models.api import build_model
from test_torch_lm_grad_a import lm_batch
from test_torch_lm_train import FAMILY_ARCH, _clone, _loss_grads, _t
from test_torch_mamba2 import _inputs as ssd_inputs
from test_torch_wkv6 import _inputs as wkv_inputs


# ---------------------------------------------------------------- the scans' training route


def _cotangents(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("T,chunk,K", [(32, 8, 8), (64, 16, 16), (48, 16, 8)])
def test_wkv6_training_route_gradients_match_reference(T, chunk, K):
    """Gradients of o and the final state through `wkv6_hopper_grad` (CPU:
    the plain scan) and through the kernel route's backward
    (`_plain_backward`) against jax.grad of the reference's `wkv6_chunked`."""
    arrs = wkv_inputs(2, T, 3, K, K, seed=12)
    do, dS = _cotangents([(2, T, 3, K), (2, 3, K, K)], seed=13)

    def jloss(*a):
        o, S = jwkv6_chunked(*a, chunk=chunk, return_state=True)
        return jnp.sum(o * do) + jnp.sum(S * dS)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, arrs))
    ts = [_t(a, grad=True) for a in arrs]
    o, S = wkv6_hopper_grad(*ts, chunk=chunk, return_state=True)
    ((o * _t(do)).sum() + (S * _t(dS)).sum()).backward()
    route = _plain_backward(wkv6_chunked, [_t(a) for a in arrs], [True] * 5,
                            (_t(do), _t(dS)), chunk=chunk)
    for t, g, w in zip(ts, route, want):
        assert_close(t.grad.numpy(), np.asarray(w), tier="loose")
        assert_close(g.numpy(), np.asarray(w), tier="loose")
    # an output without a gradient (the model drops the state), and an
    # input that needs none
    o_only = _plain_backward(wkv6_chunked, [_t(a) for a in arrs], [True] * 4 + [False],
                             (_t(do), None), chunk=chunk)
    assert o_only[4] is None
    wo = jax.grad(lambda *a: jnp.sum(jwkv6_chunked(*a, chunk=chunk) * do),
                  argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrs))
    for g, w in zip(o_only, wo):
        assert_close(g.numpy(), np.asarray(w), tier="loose")


@pytest.mark.parametrize("Bt,T,H,P,G,N,chunk", [(1, 32, 4, 8, 2, 8, 16),
                                                (2, 64, 2, 16, 1, 16, 32)])
def test_mamba2_training_route_gradients_match_reference(Bt, T, H, P, G, N, chunk):
    arrs = ssd_inputs(Bt, T, H, P, G, N, seed=17)
    dy, dh = _cotangents([(Bt, T, H, P), (Bt, H, P, N)], seed=18)

    def jloss(*a):
        y, h = jmamba2_ssd_chunked(*a, chunk=chunk, return_state=True)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, arrs))
    ts = [_t(a, grad=True) for a in arrs]
    y, h = mamba2_ssd_hopper_grad(*ts, chunk=chunk, return_state=True)
    ((y * _t(dy)).sum() + (h * _t(dh)).sum()).backward()
    route = _plain_backward(mamba2_ssd_chunked, [_t(a) for a in arrs], [True] * 6,
                            (_t(dy), _t(dh)), chunk=chunk)
    for t, g, w in zip(ts, route, want):
        assert_close(t.grad.numpy(), np.asarray(w), tier="loose")
        assert_close(g.numpy(), np.asarray(w), tier="loose")


def test_scan_training_routes_reach_the_kernel_off_the_cpu():
    """On tensors off the CPU that require grad, the training routes go to
    the kernel's launch (which needs a CUDA device), where the inference
    wrappers still refuse for want of a gradient."""
    x = torch.rand(1, 8, 2, 4)
    u = torch.zeros(2, 4)
    r = x.to("meta").requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA device"):
        wkv6_hopper_grad(r, x.to("meta"), x.to("meta"), x.to("meta"), u.to("meta"))
    with pytest.raises(RuntimeError, match="no gradient"):
        wkv6_hopper(r, x.to("meta"), x.to("meta"), x.to("meta"), u.to("meta"))
    xm, dt = torch.randn(1, 8, 2, 4, device="meta"), torch.rand(1, 8, 2, device="meta")
    A, D = torch.ones(2, device="meta"), torch.ones(2, device="meta")
    Bm = torch.randn(1, 8, 1, 4, device="meta")
    xg = xm.requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA device"):
        mamba2_ssd_hopper_grad(xg, dt, A, Bm, Bm, D)
    with pytest.raises(RuntimeError, match="no gradient"):
        mamba2_ssd_hopper(xg, dt, A, Bm, Bm, D)
    # the CPU route is the plain scan, with its own autograd
    xc = torch.rand(1, 8, 2, 4, requires_grad=True)
    wkv6_hopper_grad(xc, x, x, x, u).sum().backward()
    assert xc.grad is not None




@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_scan_kernel_route_in_the_model_matches_plain(family, monkeypatch):
    """The kernel route's autograd inside the model, remat on: with the
    kernel's launch stood in for by its plain version (the CPU has no
    kernel), `Model.loss` and its gradients equal the plain route's, the
    forward "launches" once a layer and again in remat's recompute, and the
    backward is the plain scan's."""
    import importlib

    from repro_torch.kernels import mamba2
    # the package's own name `wkv6` is the wrapper function, as in the reference
    wkv6 = importlib.import_module("repro_torch.kernels.wkv6")
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config(FAMILY_ARCH[family]).reduced(), remat=True)
    batch = lm_batch(cfg)
    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    plain = _loss_grads(cfg, _clone(init), batch, [])
    calls = []

    def stand_in(fn):
        def launch(*a, chunk):
            calls.append(1)
            with torch.no_grad():
                return fn(*a, chunk=chunk, return_state=True)
        return launch

    monkeypatch.setattr(wkv6, "launch_wkv6_kernel", stand_in(wkv6_chunked))
    monkeypatch.setattr(mamba2, "launch_mamba2_kernel", stand_in(mamba2_ssd_chunked))
    monkeypatch.setattr(ssm, "wkv6_hopper_grad", lambda *a, chunk, return_state: (
        wkv6._Wkv6Train.apply(*a, chunk)))
    monkeypatch.setattr(ssm, "mamba2_ssd_hopper_grad", lambda *a, chunk, return_state: (
        mamba2._SsdTrain.apply(*a, chunk)))
    route = _loss_grads(cfg, _clone(init), batch, [])
    assert len(calls) == 2 * cfg.n_layers
    assert_close(route[0].numpy(), plain[0].numpy())
    for x, y in zip(route[2], plain[2]):
        assert_close(x.numpy(), y.numpy(), tier="loose")
