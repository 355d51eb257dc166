"""Device resolution and the float32 policy of the port.

Entry points (`MaceGaunt`, `EquivariantServeEngine`, the chain kernel
wrapper) run on the GPU unless the caller asks for the CPU: ``device=None``
means ``cuda``, and with no GPU present that raises instead of carrying on
silently on the CPU.  ``device="cpu"`` is the explicit opt-in the tests use.

Float32 policy: the port computes in full float32.  TF32 keeps ~10 mantissa
bits, which would break the parity tier the port is held to (3e-4 relative,
the reference's f32 "identity" tier), so resolving a CUDA device turns TF32
off for both matmuls and cuDNN.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_float32_policy"]


def set_float32_policy() -> None:
    """Full-precision float32 on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda (raises without a GPU); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        set_float32_policy()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
