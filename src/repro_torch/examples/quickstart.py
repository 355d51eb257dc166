"""Quickstart: the Gaunt tensor product as a drop-in equivariant primitive,
on the port (the twin of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart             # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Five sections: the full Gaunt product three ways (the FFT pipeline, the
collocation product in torch ops, the dense oracle); O(3) equivariance; the
equivariant convolution on the eSCN and the general (2D Fourier) paths;
the 3-body selfmix; and the CG baseline timed against
`ops.gaunt_tp_fused`, the pair kernel on the card (its plain version on
the CPU).  `main` returns the max-abs errors (each expected below 1e-5)
and the times.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..core.cg import cg_full_tensor_product, gaunt_einsum_reference
from ..core.conv import EquivariantConv
from ..core.gaunt import GauntTensorProduct
from ..core.irreps import num_coeffs
from ..core.manybody import manybody_selfmix
from ..core.so3 import real_sph_harm_torch, wigner_D_real_packed
from ..device import resolve_device
from ..kernels.ops import gaunt_tp_fused, gaunt_tp_fused_torch


def _card(device: torch.device) -> str:
    """The device the times were taken on: the card's name and power limit
    as nvidia-smi gives them, or the host clock on the CPU."""
    if device.type != "cuda":
        return "cpu, host clock"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        smi = out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    return f"{torch.cuda.get_device_name(device)} ({smi})"


def _us_per_call(fn, device: torch.device, reps: int = 20) -> float:
    """Microseconds per call of ``fn`` after a warm call, synchronised."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps * 1e6


def main(device=None) -> dict:
    dev = resolve_device(device)
    L = 4
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, num_coeffs(L))), dtype=torch.float32, device=dev)
    y = torch.as_tensor(rng.normal(size=(8, num_coeffs(L))), dtype=torch.float32, device=dev)
    errors, times = {}, {}

    def err(name, got, want):
        errors[name] = float((got.double() - want.double()).abs().max())
        print(f"max |{name}| = {errors[name]:.3e}")

    # 1) the full Gaunt tensor product, three equivalent realizations
    out_fft = GauntTensorProduct(L, L, device=dev)(x, y)        # the paper's FFT pipeline
    out_fused = gaunt_tp_fused_torch(x, y, L, L, device=dev)     # collocation, torch ops
    out_ref = gaunt_einsum_reference(x, y, L, L)                 # dense oracle
    err("fft - ref", out_fft, out_ref)
    err("fused - ref", out_fused, out_ref)

    # 2) O(3) equivariance
    D_in = torch.as_tensor(wigner_D_real_packed(L, 0.3, 1.1, -0.7), dtype=torch.float32,
                           device=dev)
    D_out = torch.as_tensor(wigner_D_real_packed(2 * L, 0.3, 1.1, -0.7), dtype=torch.float32,
                            device=dev)
    err("equivariance", out_ref @ D_out.T, gaunt_einsum_reference(x @ D_in.T, y @ D_in.T, L, L))

    # 3) the equivariant convolution: eSCN's rotation-aligned fast path and
    #    the paper's general path (Y(r) on its Fourier grid, a 2D convolution)
    r = torch.as_tensor(rng.normal(size=(8, 3)), dtype=torch.float32, device=dev)
    r = r / r.norm(dim=-1, keepdim=True)
    escn = EquivariantConv(L, L, L, method="escn")(x, r)
    general_conv = EquivariantConv(L, L, L, method="general", device=dev)
    general = general_conv(x, r)
    filt_ref = gaunt_einsum_reference(x, real_sph_harm_torch(L, r), L, L, L)
    print(f"escn conv out: {tuple(escn.shape)}; general conv out: {tuple(general.shape)} "
          f"on {general_conv.backend!r}")
    err("escn conv - oracle", escn, filt_ref)
    err("general conv - oracle", general, filt_ref)
    err("general conv, resident filter - oracle", general_conv(x, general_conv.filter_rep(r)),
        filt_ref)

    # 4) many-body products (MACE-style B_nu features)
    B3 = manybody_selfmix(x, L, nu=3, Lout=L)
    print(f"3-body selfmix out: {tuple(B3.shape)}")
    err("selfmix - fold", B3, gaunt_einsum_reference(gaunt_einsum_reference(x, x, L, L), x,
                                                      2 * L, L, L))

    # 5) the speedup story: the CG baseline against the fused Gaunt product
    #    (the pair kernel on the card), timed on this device
    fast = gaunt_tp_fused(x, y, L, L, L, device=dev)
    err("pair kernel - ref", fast, gaunt_einsum_reference(x, y, L, L, L))
    card = _card(dev)
    for name, fn in (("CG (e3nn-style)", lambda: cg_full_tensor_product(x, y, L, L, L)),
                     ("Gaunt fused", lambda: gaunt_tp_fused(x, y, L, L, L, device=dev))):
        times[name] = _us_per_call(fn, dev)
        print(f"{name:>18}: {times[name]:8.1f} us/call on {card}")
    return {"errors": errors, "times_us": times, "device": card}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
