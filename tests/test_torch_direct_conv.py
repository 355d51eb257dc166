"""The direct full 2D convolution (`repro_torch.kernels.direct_conv`): its
autograd Functions against the shift-and-add they replace, their gradients
to second order, the folding of lead broadcasts, and that no tensor off the
CPU reaches the plain loop.  The ``cuda`` cases hold the kernel pair
against its plain versions on the card, count its launches through a
captured general-conv graph and skip without an sm_90 GPU (on the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_direct_conv.py``)."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core.gaunt import conv2d_full
from repro_torch.kernels import direct_conv as dc
from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats


def shift_and_add(F1, F2):
    """The direct route as it was: n2^2 in-place slice adds (the oracle)."""
    n1, n2 = F1.shape[-1], F2.shape[-1]
    N = n1 + n2 - 1
    lead = torch.broadcast_shapes(F1.shape[:-2], F2.shape[:-2])
    out = F1.new_zeros(lead + (N, N), dtype=torch.promote_types(F1.dtype, F2.dtype))
    for di in range(n2):
        for dj in range(n2):
            out[..., di: di + n1, dj: dj + n1] += F1 * F2[..., di: di + 1, dj: dj + 1]
    return out


SIZES = [(5, 7), (7, 5), (3, 9), (9, 9)]
# lead dims of F1 and F2: the filter shared over the channels (the general
# conv's), the other way round, and a broadcast the [E, C] form cannot hold
LEADS = {"f2_shared": ((2, 3, 4), (2, 3, 1)), "f1_shared": ((2, 3, 1), (2, 3, 4)),
         "mixed": ((2, 1, 4), (1, 3, 1))}


def _grids(l1, l2, n1, n2, dtype, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(*l1, n1, n1, dtype=dtype, generator=g)
    b = torch.randn(*l2, n2, n2, dtype=dtype, generator=g)
    return a.requires_grad_(grad), b.requires_grad_(grad)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("lead", sorted(LEADS))
@pytest.mark.parametrize("n1,n2", SIZES)
def test_full_conv_equals_shift_and_add(n1, n2, lead, dtype):
    """Forward and both gradients of `full_conv` (through `conv2d_full`'s
    'direct' route) against autograd through the old slice adds."""
    a, b = _grids(*LEADS[lead], n1, n2, dtype, grad=True)
    got = conv2d_full(a, b, "direct")
    want = shift_and_add(a, b)
    tol = 1e-5 if dtype == torch.complex64 else 1e-12
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    g = torch.randn_like(want)
    ga, gb = torch.autograd.grad(got, (a, b), g)
    wa, wb = torch.autograd.grad(want, (a, b), g)
    torch.testing.assert_close(ga, wa, rtol=tol, atol=tol)
    torch.testing.assert_close(gb, wb, rtol=tol, atol=tol)


@pytest.mark.parametrize("lead", ["f2_shared", "f1_shared"])
@pytest.mark.parametrize("op", ["full_conv", "valid_corr"])
def test_gradcheck_and_gradgradcheck(op, lead):
    """Both operations in complex128, first and second order: their
    backwards (each other's Functions) are the true derivatives."""
    l1, l2 = {"f2_shared": ((2, 3), (2, 1)), "f1_shared": ((2, 1), (2, 3))}[lead]
    if op == "full_conv":
        args = _grids(l1, l2, 3, 3, torch.complex128, seed=1, grad=True)
        fn = dc.full_conv
    else:
        args = _grids(l1, l2, 5, 3, torch.complex128, seed=2, grad=True)
        fn = dc.valid_corr
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def test_valid_corr_is_the_adjoint_of_full_conv():
    """<full_conv(A, B), G> == <A, valid_corr(G, B*)> == <B, valid_corr(G, A*)>
    summed over the channels B is shared by."""
    a, b = _grids((4, 6), (4, 1), 5, 7, torch.complex128, seed=3)
    G = torch.randn(4, 6, 11, 11, dtype=torch.complex128)

    def dot(x, y):
        return (x * y.conj()).sum()

    lhs = dot(dc.full_conv(a, b), G)
    torch.testing.assert_close(dot(a, dc.valid_corr(G, b.conj())), lhs)
    torch.testing.assert_close(dot(b, dc.valid_corr(G, a.conj()).sum(1, keepdim=True)), lhs)
    torch.testing.assert_close(dc.valid_corr_plain(G, b), dc.valid_corr(G, b))


def test_double_backward_matches_shift_and_add():
    """The general conv's training path differentiates the force backward
    again: the second derivative through the Functions equals autograd's
    through the slice adds."""
    outs = []
    for fn in (dc.full_conv, shift_and_add):
        a, b = _grids((3, 8), (3, 1), 5, 7, torch.complex128, seed=4, grad=True)
        out = fn(a, b)
        ga, gb = torch.autograd.grad((out.abs() ** 2).sum(), (a, b), create_graph=True)
        s = (ga.abs() ** 2).sum() + (gb.real ** 3).sum()
        outs.append(torch.autograd.grad(s, (a, b)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_the_served_broadcast_folds_without_a_copy():
    """F1 [S, n, n, C, 5, 5] with the filter F2 [S, n, n, 1, 7, 7] fold to
    [E, C] and [E, 1] views: the filter is never expanded over C."""
    a, b = _grids((2, 3, 3, 8), (2, 3, 3, 1), 5, 7, torch.complex64)
    a4, b4, lead = dc._canonical(a, b)
    assert lead == (2, 3, 3, 8)
    assert a4.shape == (18, 8, 5, 5) and b4.shape == (18, 1, 7, 7)
    assert a4.data_ptr() == a.data_ptr() and b4.data_ptr() == b.data_ptr()
    a, b = _grids(*LEADS["mixed"], 3, 3, torch.complex64)
    a4, b4, _ = dc._canonical(a, b)
    assert a4.shape == b4.shape[:2] + (3, 3) == (1, 24, 3, 3)


def test_no_tensor_off_the_cpu_reaches_the_loop(monkeypatch):
    """The plain versions run on CPU tensors only: elsewhere the route is
    the kernel pair, which takes CUDA tensors or raises."""
    def loop(*_):
        raise AssertionError("the plain loop ran")

    monkeypatch.setattr(dc, "full_conv_plain", loop)
    monkeypatch.setattr(dc, "valid_corr_plain", loop)
    a, b = _grids((2, 4), (2, 1), 5, 7, torch.complex64)
    with pytest.raises(ValueError, match="CUDA device"):
        conv2d_full(a.to("meta"), b.to("meta"), "direct")
    with pytest.raises(ValueError, match="CUDA device"):
        dc.valid_corr(torch.zeros(2, 4, 11, 11, dtype=torch.complex64, device="meta"),
                      b.to("meta"))
    with pytest.raises(AssertionError, match="plain loop"):
        conv2d_full(a, b, "direct")


def test_launch_counters_are_kernel_stats():
    reset_kernel_stats()
    stats = kernel_stats()
    assert stats["direct_conv"] == 0 and stats["direct_conv_adjoint"] == 0
    a, b = _grids((2, 4), (2, 1), 5, 7, torch.complex64, grad=True)
    torch.autograd.grad(dc.full_conv(a, b).abs().sum(), (a, b))
    # the CPU runs the plain versions: no kernel launched
    assert kernel_stats()["direct_conv"] == kernel_stats()["direct_conv_adjoint"] == 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 GPU: the CUDA kernel has no CPU mode")
    from repro_torch.device import set_float32_policy

    set_float32_policy()
    return torch.device("cuda")


# the served shape, then the odd shapes (the last two on the generic kernels)
CARD_CASES = [((5, 7), _CS.DIRECT_LEAD, _CS.DIRECT_LEAD[:-1] + (1,))] + _CS.DIRECT_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_kernel_pair_matches_plain_on_card(cuda_device, case, dtype):
    """Forward, both adjoints and the double backward against the plain
    versions on the card (the double backward on one row's grids at the
    served shape); f32 identity tier at complex64."""
    (n1, n2), l1, l2 = CARD_CASES[case]
    if case == 0 and dtype == "complex128":
        pytest.skip("the served shape runs at complex64")
    A, B = _CS._direct_grids(l1, l2, n1, n2, cuda_device, seed=case, dtype=dtype)
    fwd, adj, dbl, _ = _CS.compare_direct_conv(A, B, second=case != 0)
    if case == 0:
        _, _, dbl, _ = _CS.compare_direct_conv(A[:1, :1].contiguous(), B[:1, :1].contiguous())
    tol = 3e-4 if dtype == "complex64" else 1e-12
    assert fwd <= tol and adj <= tol and dbl <= tol, (fwd, adj, dbl)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_loop(cuda_device, monkeypatch):
    """Forward, backward and double backward on CUDA tensors launch the
    kernels (one forward, one adjoint pass for both gradients) and never
    the plain loop."""
    def loop(*_):
        raise AssertionError("the plain loop ran")

    monkeypatch.setattr(dc, "full_conv_plain", loop)
    monkeypatch.setattr(dc, "valid_corr_plain", loop)
    a, b = _CS._direct_grids((64, 40), (64, 1), 5, 7, cuda_device, seed=5)
    a.requires_grad_(True)
    b.requires_grad_(True)
    reset_kernel_stats()
    out = conv2d_full(a, b, "direct")
    ga, gb = torch.autograd.grad((out.abs() ** 2).sum(), (a, b), create_graph=True)
    assert kernel_stats()["direct_conv"] == 1 and kernel_stats()["direct_conv_adjoint"] == 1
    torch.autograd.grad((ga.abs() ** 2).sum() + (gb.abs() ** 2).sum(), (a, b))
    torch.cuda.synchronize()
    assert kernel_stats()["direct_conv"] > 1 and kernel_stats()["direct_conv_adjoint"] > 1


@pytest.mark.cuda
def test_general_conv_graph_counts_the_kernels_and_replays_to_eager(cuda_device):
    """A captured general-conv bucket: a forward and an adjoint launch a
    layer per replay (`SlotPool.launches`), counted through the replays,
    and the served results equal eager evaluation."""
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantServeEngine
    from repro_torch.serve.pools import default_buckets

    cfg = dataclasses.replace(gaunt_mace_ff, conv_impl="general", channels=16)
    model = MaceGaunt(cfg, device=cuda_device, generator=torch.Generator().manual_seed(0))
    eng = EquivariantServeEngine(model, buckets=default_buckets(8, 2))
    eng.warmup()
    for pool in eng.pools:
        assert pool.launches.get("direct_conv") == cfg.n_layers
        assert pool.launches.get("direct_conv_adjoint") == cfg.n_layers
    reqs = _CS.make_requests([3, 5, 8, 8], cfg.n_species, seed=11)
    replays = [p.replays for p in eng.pools]
    reset_kernel_stats()
    eng.run(reqs)
    torch.cuda.synchronize()
    steps = sum(p.replays - r0 for p, r0 in zip(eng.pools, replays))
    assert steps > 0
    assert kernel_stats()["direct_conv"] == kernel_stats()["direct_conv_adjoint"] \
        == steps * cfg.n_layers
    worst_e, worst_f = _CS.served_vs_direct(model, reqs, cuda_device)
    assert worst_e <= 3e-4 and worst_f <= 2e-3
