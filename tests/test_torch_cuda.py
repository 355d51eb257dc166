"""The Hopper chain kernel on the card against its plain version.  Marked
``cuda``: these skip without an sm_90 GPU (run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``)."""
import pytest
import torch

from repro_torch.kernels.gaunt_fused import (gaunt_chain_fused_hopper,
                                             gaunt_chain_fused_torch,
                                             kernel_stats, reset_kernel_stats)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 GPU: the CUDA kernel has no CPU mode")
    from repro_torch.device import set_float32_policy

    set_float32_policy()
    return torch.device("cuda")


@pytest.mark.parametrize("Ls,Lout,gated", [((2, 2, 2), 2, True), ((1, 1), 2, False),
                                           ((1, 2, 1, 2), 4, True)])
def test_kernel_matches_plain_on_card(cuda_device, Ls, Lout, gated):
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(1000, (L + 1) ** 2, device=cuda_device, generator=g) for L in Ls]
    gate = (tuple(torch.randn(1000, device=cuda_device, generator=g) for _ in range(2))
            if gated else None)
    reset_kernel_stats()
    got = gaunt_chain_fused_hopper(xs, Ls, Lout, gate=gate)
    assert kernel_stats()["gaunt_chain"] == 1
    want = gaunt_chain_fused_torch(xs, Ls, Lout, gate=gate)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 3e-4 * max(1.0, want.abs().max().item()), err
