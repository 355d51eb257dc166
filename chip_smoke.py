"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints no
result line):
  1. device and build — the card, torch/CUDA versions, the nvcc build of
     every kernel source, all started together (time and ptxas report);
  2. kernels vs plain — the Gaunt chain kernel against its plain PyTorch
     version on the card, forward and gradients, at the main-path shape
     and at the reference test chains (sh and grid entries/exits); the
     pair kernel against its plain version at the reference test shapes
     and at the full-width shape;
  3. main path — full-width `gaunt_mace_ff` (chain_tune='measure',
     grid_gate='on') served by `EquivariantServeEngine` (4 slots x 32 atoms)
     for seeded LJ clusters of 8-32 atoms: served == direct evaluation,
     finite, rotation invariant/equivariant, and the chain kernel launched;
  4. times — chain kernel and plain version (CUDA events per call, median
     of 50; device time from torch.profiler), the kernel's bound (counted
     at the grid's distinct sphere points, `sample_classes`), one serve
     step, and a profiled serve step (device busy time, idle share, top
     kernels);
  5. pairwise path — the pairwise tensor product `ops.gaunt_tp_fused` at
     (L1, L2, Lout) = (6, 6, 6) on 81,920 rows (EquiformerV2's OC20 width,
     lmax 6 x 128 channels, 640 nodes): the pair kernel launched, finite,
     equal to the dense oracle on a row subset, equivariant, and timed
     against its plain version, its bound (the exact algorithm with the
     fewest operations) and the dense Gaunt contraction in library calls;
  6. Fig. 1(a) sweep — `plan(L, L, L, batch_hint=512, tune='measure')` on
     [4, 128, (L+1)^2] operands for L in 1..6 and 8: every candidate's
     time and the pick, the CG baseline, `GauntTensorProduct` and
     `ops.gaunt_tp_fused`, each against its dense oracle;
  7. conv_filter sweep — the measured `conv_filter` pick for L in 1..6 at
     1024 edges, and a plan pinned to the pair kernel against
     `escn_aligned`.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.  Needs no network and imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32_IDENTITY_TOL = 3e-4   # the repo's f32 "identity" tier (same math, two routes)
F32_TRANSFORM_TOL = 5e-4  # f32 "transform" tier (rotate -> evaluate -> compare)
F32_LOOSE_TOL = 2e-3      # f32 "loose" tier (gradients)
# the pair kernel against its plain version: both are f32 sums of the same
# products, only in another order, so they agree to a few f32 roundings
PAIR_VS_PLAIN_TOL = 1e-5
PAIR_EQUIVARIANCE_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max|ref|))."""
    err = float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0
    scale = max(1.0, float(ref.double().abs().max())) if ref.numel() else 1.0
    return err, err / scale


def smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# --------------------------------------------------------------------------
# phase 1: device and build
# --------------------------------------------------------------------------


def phase_device_and_build():
    import torch
    from repro_torch.device import set_float32_policy
    from repro_torch.kernels import build

    set_float32_policy()
    print(f"[device] {smi_line()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} capability "
          f"{torch.cuda.get_device_capability(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    results = build.build_all()
    print(f"[build] {len(results)} source(s) in {time.perf_counter() - t0:.2f} s")
    for r in results:
        print(f"[build] {r.name}: nvcc {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")


# --------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------


def _chain_inputs(Ls, entries, B, gated, device, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    xs = []
    for L, e in zip(Ls, entries):
        if e == "sh":
            xs.append(torch.as_tensor(rng.normal(size=(B, (L + 1) ** 2)),
                                      dtype=torch.float32, device=device))
        else:
            shape = (B, 2 * L + 1, L + 1)
            xs.append(torch.complex(
                torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=device),
                torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=device)))
    gate = None
    if gated:
        gate = tuple(torch.as_tensor(rng.normal(size=(B,)), dtype=torch.float32,
                                     device=device) for _ in range(2))
    return xs, gate


def compare_chain(Ls, Lout, entries, out_entry, B, gated, device, seed=0):
    """Forward and gradients of the kernel route vs the plain route on the
    same inputs -> (forward abs err, forward rel err, grad rel err)."""
    import torch
    from repro_torch.kernels.gaunt_fused import (gaunt_chain_fused_hopper,
                                                 gaunt_chain_fused_torch)

    results = []
    for fn in (gaunt_chain_fused_hopper, gaunt_chain_fused_torch):
        xs, gate = _chain_inputs(Ls, entries, B, gated, device, seed)
        leaves = [x.requires_grad_(True) for x in xs]
        if gate is not None:
            leaves += [g.requires_grad_(True) for g in gate]
        out = fn(xs, Ls, Lout, entries=entries, out_entry=out_entry, gate=gate)
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed + 1),
                        dtype=out.real.dtype).to(device)
        w = w if not out.is_complex() else torch.complex(w, w)
        loss = (out * w).real.sum()
        grads = torch.autograd.grad(loss, leaves)
        results.append((out.detach(), [g.detach() for g in grads]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    (o_k, g_k), (o_p, g_p) = results
    if o_k.is_complex():
        o_k, o_p = torch.view_as_real(o_k), torch.view_as_real(o_p)
    err, rel = rel_err(o_k, o_p)
    grel = 0.0
    for a, b in zip(g_k, g_p):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        grel = max(grel, rel_err(a, b)[1])
    return err, rel, grel


def phase_kernel_vs_plain(device, rows: int):
    """Main-path chain (gated and ungated) at ``rows`` rows, then the
    reference's test chains with 'grid' entries and exits."""
    cases = [
        ((2, 2, 2), 2, ("sh",) * 3, "sh", rows, True),
        ((2, 2, 2), 2, ("sh",) * 3, "sh", rows, False),
        ((1, 1), 2, ("sh", "sh"), "sh", 257, False),
        ((1, 1), 2, ("sh", "sh"), "grid", 257, True),
        ((2, 1, 2), 3, ("grid", "sh", "sh"), "sh", 300, True),
        ((2, 1, 2), 3, ("sh", "grid", "sh"), "sh", 300, False),
        ((1, 2, 1, 2), 4, ("sh",) * 4, "sh", 129, True),
        ((1, 2, 1, 2), 6, ("sh", "sh", "grid", "sh"), "grid", 129, False),
    ]
    main_err = 0.0
    for i, (Ls, Lout, entries, out_entry, B, gated) in enumerate(cases):
        err, rel, grel = compare_chain(Ls, Lout, entries, out_entry, B, gated, device, seed=i)
        ok = rel <= F32_IDENTITY_TOL and grel <= F32_LOOSE_TOL
        print(f"[kernel] Ls={Ls} Lout={Lout} entries={entries} exit={out_entry} "
              f"B={B} gated={gated}: fwd max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol {F32_IDENTITY_TOL}), grad rel {grel:.3e} (tol {F32_LOOSE_TOL}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain version for Ls={Ls}")
        if i < 2:
            main_err = max(main_err, err)
    return main_err


PAIR_CASES = [(1, 1, 2), (2, 2, 4), (3, 2, 3), (4, 4, 8), (6, 6, 6), (6, 6, 12),
              (8, 8, 8), (8, 8, 16)]
PAIR_MAIN = (6, 6, 6)


def _pair_rows(L1, L2, B, device, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=(B, (L + 1) ** 2)), dtype=torch.float32,
                                 device=device) for L in (L1, L2))


def phase_pair_vs_plain(device, main_rows: int) -> float:
    """The pair kernel (`launch_pair_kernel`) against `pair_plain` on the same
    rows and folded matrices; -> max abs error at the full-width shape."""
    import torch
    from repro_torch.core import constants as _c
    from repro_torch.kernels.gaunt_fused import gaunt_fused_hopper, pair_plain

    main_err = 0.0
    for i, (L1, L2, Lout) in enumerate(PAIR_CASES):
        rows = [1, 7, 300] + ([main_rows] if (L1, L2, Lout) == PAIR_MAIN else [])
        mats = [_c.to_torch(a, device) for a in _c.pair_matrices(L1, L2, Lout)]
        for B in rows:
            x1, x2 = _pair_rows(L1, L2, B, device, seed=10 * i + B)
            with torch.no_grad():
                got = gaunt_fused_hopper(x1, x2, L1, L2, Lout)
                want = pair_plain(x1, x2, *mats)
            if device.type == "cuda":
                torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            ok = rel <= PAIR_VS_PLAIN_TOL and bool(torch.isfinite(got).all())
            print(f"[pair] (L1,L2,Lout)=({L1},{L2},{Lout}) B={B} G={mats[0].shape[1]}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (tol {PAIR_VS_PLAIN_TOL}: f32 "
                  f"sums of the same products in another order) {'ok' if ok else 'FAIL'}")
            check(ok, f"pair kernel disagrees with its plain version at "
                      f"({L1},{L2},{Lout}) B={B}")
            if B == main_rows:
                main_err = err
    return main_err


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------


def random_rotation(seed: int):
    import numpy as np

    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def make_requests(sizes, n_species, seed):
    from repro_torch.data.molecules import lj_dataset
    from repro_torch.serve.engine import EquivariantRequest

    reqs = []
    for i, n in enumerate(sizes):
        d = lj_dataset(1, n_atoms=n, n_species=n_species, seed=seed + i)
        reqs.append(EquivariantRequest(species=d["species"][0], pos=d["pos"][0], rid=i))
    return reqs


def phase_main_path(device, cfg, n_slots, max_atoms, sizes):
    import numpy as np
    import torch
    from repro_torch.core import engine as _engine
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantServeEngine

    model = MaceGaunt(cfg, device=device, generator=torch.Generator().manual_seed(0))
    eng = EquivariantServeEngine(model, n_slots=n_slots, max_atoms=max_atoms)
    t0 = time.perf_counter()
    eng.warmup()
    print(f"[main] warmup {time.perf_counter() - t0:.2f} s "
          f"(rows per chain {n_slots * max_atoms * cfg.channels})")
    ge = _engine.get_engine()
    picks = {}
    for key, times in ge.measured_times.items():
        if isinstance(key, _engine.PlanKey):
            continue  # pairwise plans (phases 6 and 7)
        pick = picks[key] = min(times, key=times.get)
        spread = ge.measured_spread[key]
        print(f"[main] measured chain Ls={key[0]} rows={key[3]} gate={key[5]} "
              f"({'CUDA events' if device.type == 'cuda' else 'host clock'} per call, "
              f"median of {_engine._MEASURE_REPS}, [min, max]): "
              + ", ".join(f"{k} {v * 1e3:.4f} ms [{spread[k][0] * 1e3:.4f}, "
                          f"{spread[k][1] * 1e3:.4f}]" for k, v in times.items())
              + f" -> {pick}")
    reqs = make_requests(sizes, cfg.n_species, seed=100)
    reset_kernel_stats()
    t0 = time.perf_counter()
    eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_stats()["gaunt_chain"]
    summ = eng.metrics.summary()
    print(f"[main] served {len(reqs)} requests ({sum(sizes)} atoms) in {wall:.3f} s, "
          f"{summ['steps']} steps, step p50 {summ['step_ms_p50']:.2f} ms, "
          f"kernel launches {launches}")
    check(all(r.done and not r.rejected for r in reqs), "a request did not complete")
    # served == direct evaluation of each molecule alone
    worst_e = worst_f = 0.0
    for r in reqs:
        check(np.isfinite(r.energy) and np.all(np.isfinite(r.forces)),
              f"request {r.rid}: non-finite result")
        check(r.forces.shape == (len(r.species), 3), f"request {r.rid}: forces shape")
        e, f = model.energy_forces(torch.as_tensor(r.species, device=device),
                                   torch.as_tensor(r.pos, device=device))
        e, f = float(e), f.cpu().numpy()
        worst_e = max(worst_e, abs(r.energy - e) / max(1.0, abs(e)))
        worst_f = max(worst_f, float(np.abs(r.forces - f).max())
                      / max(1e-30, float(np.abs(f).max())))
    print(f"[main] served vs direct: energy rel {worst_e:.3e} (tol {F32_IDENTITY_TOL}), "
          f"forces rel {worst_f:.3e} (tol {F32_LOOSE_TOL})")
    check(worst_e <= F32_IDENTITY_TOL, "served energy differs from direct evaluation")
    check(worst_f <= F32_LOOSE_TOL, "served forces differ from direct evaluation")
    # rotation: energy invariant, forces equivariant
    r0 = reqs[-1]
    Q = random_rotation(7)
    sp = torch.as_tensor(r0.species, device=device)
    e0, f0 = model.energy_forces(sp, torch.as_tensor(r0.pos, device=device))
    e1, f1 = model.energy_forces(sp, torch.as_tensor((r0.pos @ Q.T).astype(np.float32),
                                                     device=device))
    f0, f1 = f0.cpu().numpy(), f1.cpu().numpy()
    de = abs(float(e1) - float(e0)) / max(1.0, abs(float(e0)))
    df = float(np.abs(f1 - f0 @ Q.T).max()) / max(1e-30, float(np.abs(f0).max()))
    print(f"[main] rotation: energy rel {de:.3e} (tol {F32_TRANSFORM_TOL}), forces rel "
          f"{df:.3e} (tol {F32_LOOSE_TOL}); |E| {abs(float(e0)):.4e} max|F| "
          f"{float(np.abs(f0).max()):.4e}")
    check(de <= F32_TRANSFORM_TOL and df <= F32_LOOSE_TOL, "rotation check failed")
    served_pick = picks.get(ge.chain_measure_key(
        (cfg.L,) * cfg.nu, cfg.L, cfg.compute_dtype, n_slots * max_atoms * cfg.channels,
        (0,) * cfg.nu, True, device))
    print(f"[main] served chain backend: {served_pick}")
    kernel = "fused_hopper" if device.type == "cuda" else "fused_torch"
    check(served_pick == kernel, f"the measured pick for the served chain is "
                                 f"{served_pick!r}, not the kernel")
    if device.type == "cuda":
        check(launches > 0, "the chain kernel was not launched on the served steps")
    return launches, summ, model


# --------------------------------------------------------------------------
# phase 4: times
# --------------------------------------------------------------------------


def sample_classes(Ts, tol: float = 1e-9):
    """Class index per sample column: columns that agree in every T_i share
    a class.

    Such samples give the same product value in every row, so one
    evaluation serves the class and its rows of P add up: the output is the
    same.  With 'sh' entries the torus grid is a double cover of the sphere
    ((t, p) and (2 pi - t, p + pi) are one point, and each pole row is one
    point), so about half the columns repeat; 'grid' entries are functions
    on the torus and repeat nothing.  ``Ts`` are the float64 sampling
    matrices.
    """
    import numpy as np

    M = np.concatenate(Ts, axis=0)
    scale = max(1.0, float(np.abs(M).max()))
    cls = np.full(M.shape[1], -1)
    n = 0
    for g in range(M.shape[1]):
        if cls[g] < 0:
            same = (cls < 0) & (np.abs(M - M[:, g:g + 1]).max(axis=0) <= tol * scale)
            cls[same] = n
            n += 1
    return cls


def chain_work(n_rows: int, ds, G: int, dout: int, gated: bool):
    """(FLOPs, bytes) the chain function needs at ``G`` distinct samples:
    each input byte read once, each output byte written once (T and P
    included)."""
    n = len(ds)
    flops = n_rows * (2 * G * sum(ds) + G * (n - 1) + (2 * G if gated else 0)
                      + 2 * G * dout)
    nbytes = 4 * (n_rows * (sum(ds) + dout + (2 if gated else 0))
                  + sum(ds) * G + G * dout)
    return flops, nbytes


def event_ms(fn, reps: int = 50) -> float:
    """Median over ``reps`` single launches, each between CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _kernel_events(prof):
    """The profiler's GPU-side events (kernels, memsets, copies)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _device_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_ms(fn, reps: int = 20):
    """GPU time per call from torch.profiler: the summed device time of the
    kernels ``fn`` launches, over ``reps`` calls; None when the profiler
    records no device time (then only the event times stand)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in _kernel_events(prof))
    return total / reps / 1e3 if total > 0 else None


def phase_times(device, rows: int, Ls=(2, 2, 2), Lout: int = 2):
    import numpy as np
    import torch
    from repro_torch.core import constants as _c
    from repro_torch.kernels.gaunt_fused import chain_plain, launch_chain_kernel

    Ts_np, P_np = _c.chain_matrices(Ls, Lout, ("sh",) * len(Ls), "sh",
                                    pad_lanes=False, dtype="float32")
    Ts = [_c.to_torch(T, device) for T in Ts_np]
    P = _c.to_torch(P_np, device)
    rng = np.random.default_rng(0)
    flat = [torch.as_tensor(rng.normal(size=(rows, T.shape[0])), dtype=torch.float32,
                            device=device) for T in Ts]
    gs, gb = (torch.as_tensor(rng.normal(size=(rows, 1)), dtype=torch.float32,
                              device=device) for _ in range(2))
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1 = event_ms(lambda: chain_plain(flat, Ts, P, gs, gb))
    k1 = event_ms(lambda: launch_chain_kernel(flat, Ts, P, gs, gb))
    k2 = event_ms(lambda: launch_chain_kernel(flat, Ts, P, gs, gb))
    p2 = event_ms(lambda: chain_plain(flat, Ts, P, gs, gb))
    G, dout = P.shape
    Gd = int(sample_classes(_c.chain_matrices(Ls, Lout, ("sh",) * len(Ls), "sh",
                                              pad_lanes=False, dtype="float64")[0]).max()) + 1
    flops, nbytes = chain_work(rows, [T.shape[0] for T in Ts], Gd, dout, True)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[times] chain Ls={Ls} Lout={Lout} gated rows={rows} G={G}: kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms per call (CUDA events "
          f"around one call from Python, median of 50: host overhead included)")
    kd = device_ms(lambda: launch_chain_kernel(flat, Ts, P, gs, gb))
    pd = device_ms(lambda: chain_plain(flat, Ts, P, gs, gb))
    if kd is not None and pd is not None:
        kernel_ms, plain_ms = kd, pd
        print(f"[times] device time per call (torch.profiler, 20 calls): kernel "
              f"{kd:.5f} ms, plain {pd:.5f} ms")
    else:
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        print("[times] device time per call: not measured (the profiler saw no "
              "device time); the event times stand")
    print(f"[times] work at {Gd} distinct sphere points of the G={G} samples: "
          f"{flops / 1e6:.2f} MFLOP, {nbytes / 1e6:.3f} MB -> bound {bound_ms:.5f} ms "
          f"by {bound_by} (67 TFLOP/s f32, 3.35 TB/s); kernel at "
          f"{bound_ms / kernel_ms * 100:.1f}% of bound (it evaluates all {G})")
    print("[times] library_ms: none — no single PyTorch call computes the chain "
          "collocation product")
    return kernel_ms, plain_ms, bound_ms, bound_by


def serve_step_ms(model, n_slots, max_atoms, reps: int = 5) -> float:
    """Host-clock time of one full serve step (all slots occupied), median."""
    from repro_torch.serve.engine import EquivariantServeEngine

    cfg = model.cfg
    eng = EquivariantServeEngine(model, n_slots=n_slots, max_atoms=max_atoms, warmup=True)
    times = []
    for k in range(reps):
        for r in make_requests([max_atoms] * n_slots, cfg.n_species, seed=500 + k):
            check(eng.add_request(r), "no free slot for the timing step")
        t0 = time.perf_counter()
        eng.step()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def profile_step(model, n_slots, max_atoms, top: int = 10) -> None:
    """One full serve step under torch.profiler: wall time, summed device
    time, the device's idle share, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import EquivariantServeEngine

    eng = EquivariantServeEngine(model, n_slots=n_slots, max_atoms=max_atoms, warmup=True)
    for r in make_requests([max_atoms] * n_slots, model.cfg.n_species, seed=900):
        check(eng.add_request(r), "no free slot for the profiled step")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted(_kernel_events(prof), key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in events) / 1e3
    if busy <= 0:
        print("[profile] the profiler saw no device time; step breakdown not measured")
        return
    print(f"[profile] serve step (profiled): wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(e.count for e in events)} GPU events")
    for e in events[:top]:
        print(f"[profile]   {_device_us(e) / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    chain = sum(_device_us(e) for e in events if "gaunt_chain" in e.key) / 1e3
    print(f"[profile]   chain kernel: {chain:.3f} ms ({chain / busy * 100:.1f}% of busy)")


# --------------------------------------------------------------------------
# phase 5: the pairwise path at full width
# --------------------------------------------------------------------------


def pair_work(n_rows: int, d1: int, d2: int, G: int, dout: int):
    """(FLOPs, bytes) the collocation algorithm needs at ``G`` distinct
    samples: each input byte read once (T1, T2 and P included), each output
    byte written once."""
    flops = n_rows * (2 * G * (d1 + d2) + G + 2 * G * dout)
    nbytes = 4 * (n_rows * (d1 + d2 + dout) + (d1 + d2) * G + G * dout)
    return flops, nbytes


def pair_work_sparse(n_rows: int, Gt):
    """(FLOPs, bytes) of the sparse contraction over the nonzeros of the
    exact real Gaunt tensor ``Gt`` [d1, d2, dout] (float64): one product
    x1_i x2_j per (i, j) with a nonzero, then one FMA per nonzero; the rows
    read and written once, the nonzero values read once."""
    import numpy as np

    nz = np.abs(Gt) > 1e-9 * np.abs(Gt).max()  # roundoff of the exact builder is ~1e-16
    nnz, pairs = int(nz.sum()), int(nz.any(axis=-1).sum())
    d1, d2, dout = Gt.shape
    flops = n_rows * (pairs + 2 * nnz)
    nbytes = 4 * (n_rows * (d1 + d2 + dout) + nnz)
    return flops, nbytes, nnz, pairs


def bound_of(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_pair_main(device, rows: int):
    """`ops.gaunt_tp_fused` at (6, 6, 6) on ``rows`` rows, the kernel's
    launches counted over this run alone; checks against the dense oracle
    on a row subset and under rotation.  -> (launches, output, inputs)."""
    import numpy as np
    import torch
    from repro_torch.core import so3
    from repro_torch.core.cg import gaunt_einsum_reference
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.kernels.ops import gaunt_tp_fused

    L1, L2, Lout = PAIR_MAIN
    x1, x2 = _pair_rows(L1, L2, rows, device, seed=2024)
    reset_kernel_stats()
    with torch.no_grad():
        out = gaunt_tp_fused(x1, x2, L1, L2, Lout, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_stats()["gaunt_pair"]
    print(f"[pairwise] ops.gaunt_tp_fused ({L1},{L2},{Lout}) on {rows} rows "
          f"(640 nodes x 128 channels at full width) -> {tuple(out.shape)}, "
          f"pair kernel launches {launches}")
    check(out.shape == (rows, (Lout + 1) ** 2), "pairwise output shape")
    check(bool(torch.isfinite(out).all()), "pairwise output is not finite")
    if device.type == "cuda":
        check(launches > 0, "the pair kernel was not launched on the pairwise path")
    sub = slice(0, min(rows, 4096))
    want = gaunt_einsum_reference(x1[sub].double(), x2[sub].double(), L1, L2, Lout)
    err, rel = rel_err(out[sub], want)
    print(f"[pairwise] vs the dense Gaunt oracle (f64, first {want.shape[0]} rows): "
          f"max_abs_err {err:.3e} rel {rel:.3e} (tol {F32_IDENTITY_TOL})")
    check(rel <= F32_IDENTITY_TOL, "pairwise output differs from the dense oracle")
    angles = (0.4, 1.3, -2.1)
    D1, D2, D3 = (torch.as_tensor(so3.wigner_D_real_packed(L, *angles), dtype=torch.float32,
                                  device=device) for L in (L1, L2, Lout))
    with torch.no_grad():
        rot = gaunt_tp_fused(x1 @ D1.T, x2 @ D2.T, L1, L2, Lout, device=device)
        want_rot = out @ D3.T
    err, rel = rel_err(rot, want_rot)
    print(f"[pairwise] equivariance out(D x1, D x2) vs D out(x1, x2): max_abs_err "
          f"{err:.3e} rel {rel:.3e} (tol {PAIR_EQUIVARIANCE_TOL})")
    check(rel <= PAIR_EQUIVARIANCE_TOL, "pairwise product is not equivariant")
    return launches, (x1, x2)


def phase_pair_times(device, x1, x2):
    """Kernel and plain version at the full-width shape, in turns (plain,
    kernel, kernel, plain), device times from torch.profiler, the bound of
    the exact algorithm with the fewest operations, and the dense Gaunt
    contraction in library calls."""
    import torch
    from repro_torch.core import constants as _c
    from repro_torch.core.engine import _gaunt_contract
    from repro_torch.kernels.gaunt_fused import launch_pair_kernel, pair_plain

    L1, L2, Lout = PAIR_MAIN
    T1, T2, P = (_c.to_torch(a, device) for a in _c.pair_matrices(L1, L2, Lout))
    rows, (d1, d2), (G, dout) = x1.shape[0], (x1.shape[1], x2.shape[1]), P.shape
    full = _c.chain_matrices((L1, L2), Lout, ("sh", "sh"), "sh", pad_lanes=False,
                             dtype="float64")[0]
    Gd = int(sample_classes(full).max()) + 1
    check(Gd == G, f"the folded grid has {G} samples, the sphere {Gd} distinct points")
    with torch.no_grad():
        p1 = event_ms(lambda: pair_plain(x1, x2, T1, T2, P))
        k1 = event_ms(lambda: launch_pair_kernel(x1, x2, T1, T2, P))
        k2 = event_ms(lambda: launch_pair_kernel(x1, x2, T1, T2, P))
        p2 = event_ms(lambda: pair_plain(x1, x2, T1, T2, P))
        kd = device_ms(lambda: launch_pair_kernel(x1, x2, T1, T2, P))
        pd = device_ms(lambda: pair_plain(x1, x2, T1, T2, P))
    print(f"[times] pair ({L1},{L2},{Lout}) rows={rows} G={G} of {full[0].shape[1]} torus "
          f"samples: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms per call "
          f"(CUDA events around one call from Python, median of 50)")
    if kd is not None and pd is not None:
        kernel_ms, plain_ms = kd, pd
        print(f"[times] pair device time per call (torch.profiler, 20 calls): kernel "
              f"{kd:.5f} ms, plain {pd:.5f} ms")
    else:
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        print("[times] pair device time per call: not measured (the profiler saw no "
              "device time); the event times stand")
    # the bound is that of the exact algorithm with the fewest operations:
    # the collocation product at the distinct sphere points, or the sparse
    # contraction over the Gaunt tensor's nonzeros
    flops_c, nbytes_c = pair_work(rows, d1, d2, G, dout)
    Gt = _c.gaunt_dense(L1, L2, Lout, "float64")
    flops_s, nbytes_s, nnz, pairs = pair_work_sparse(rows, Gt)
    bounds = [(*bound_of(f, b), f, b, name) for f, b, name in
              ((flops_c, nbytes_c, f"collocation at {G} distinct sphere points"),
               (flops_s, nbytes_s, f"sparse contraction over {nnz} nonzeros "
                                   f"({pairs} operand pairs)"))]
    for b_ms, b_by, f, b, name in bounds:
        print(f"[times] pair work by {name}: {f / 1e9:.4f} GFLOP ({f // rows} per row), "
              f"{b / 1e6:.3f} MB -> {b_ms:.5f} ms by {b_by} (67 TFLOP/s f32, 3.35 TB/s)")
    bound_ms, bound_by, _, _, least = min(bounds)
    print(f"[times] pair bound {bound_ms:.5f} ms by {bound_by} ({least}); kernel at "
          f"{bound_ms / kernel_ms * 100:.1f}% of bound")
    # the library yardstick: the dense Gaunt contraction as one torch.einsum
    # call and as the two matmuls of the dense_einsum backend; the faster
    # stands as library_ms (the port's kernel route calls neither)
    Gf = _c.to_torch(_c.gaunt_dense(L1, L2, Lout, "float32"), device)
    lib = {"torch.einsum": lambda: torch.einsum("...i,...j,ijk->...k", x1, x2, Gf),
           "two matmuls": lambda: _gaunt_contract(x1, x2, Gf)}
    lib_ms = {}
    with torch.no_grad():
        for lname, fn in lib.items():
            ev = event_ms(fn)
            dv = device_ms(fn)
            lib_ms[lname] = dv if kd is not None and dv is not None else ev
            print(f"[times] pair library {lname}: {ev:.4f} ms per call (CUDA events, median "
                  f"of 50), device " + (f"{dv:.5f} ms" if dv is not None else "not measured"))
    library_name = min(lib_ms, key=lib_ms.get)
    library_ms = lib_ms[library_name]
    print(f"[times] pair library_ms {library_ms:.5f} ({library_name}); kernel "
          f"{kernel_ms:.5f} ms")
    return kernel_ms, plain_ms, bound_ms, bound_by, library_ms


# --------------------------------------------------------------------------
# phases 6 and 7: the Fig. 1(a) sweep and the conv_filter sweep
# --------------------------------------------------------------------------


def cg_dense_numpy(L1: int, L2: int, Lout: int):
    """The CG baseline's own dense oracle: every path's real CG block placed
    in one [(L1+1)^2, (L2+1)^2, (Lout+1)^2] tensor (float64)."""
    import numpy as np
    from repro_torch.core.so3 import real_clebsch_gordan_block

    C = np.zeros(((L1 + 1) ** 2, (L2 + 1) ** 2, (Lout + 1) ** 2))
    for l1 in range(L1 + 1):
        for l2 in range(L2 + 1):
            for l3 in range(abs(l1 - l2), min(Lout, l1 + l2) + 1):
                C[l1 * l1:(l1 + 1) ** 2, l2 * l2:(l2 + 1) ** 2, l3 * l3:(l3 + 1) ** 2] = \
                    real_clebsch_gordan_block(l1, l2, l3)
    return C


def print_measured(tag, ge, key, pick, device):
    times, spread = ge.measured_times[key], ge.measured_spread[key]
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"[{tag}] candidates ({clock} per call, median of 20, [min, max]): "
          + ", ".join(f"{k} {v * 1e3:.4f} ms [{spread[k][0] * 1e3:.4f}, "
                      f"{spread[k][1] * 1e3:.4f}]" for k, v in times.items())
          + f" -> {pick}")


def phase_fig1a(device, Ls=(1, 2, 3, 4, 5, 6, 8), rows: int = 4, channels: int = 128):
    """bench_feature_interaction's sweep: the measured pick per L and the
    times of the CG baseline, GauntTensorProduct and ops.gaunt_tp_fused."""
    import numpy as np
    import torch
    from repro_torch.core import engine as _engine
    from repro_torch.core.cg import cg_full_tensor_product, gaunt_einsum_reference
    from repro_torch.core.gaunt import GauntTensorProduct
    from repro_torch.kernels.ops import gaunt_tp_fused

    ge = _engine.get_engine()
    for L in Ls:
        d = (L + 1) ** 2
        x1, x2 = (torch.as_tensor(np.random.default_rng(s).normal(size=(rows, channels, d)),
                                  dtype=torch.float32, device=device) for s in (0, 1))
        p = _engine.plan(L, L, L, batch_hint=rows * channels, tune="measure",
                         requires_grad=False, device=device)
        print_measured(f"fig1a L={L}", ge, p.key, p.backend, device)
        tp = GauntTensorProduct(L, L, L, device=device)
        oracle = gaunt_einsum_reference(x1.double(), x2.double(), L, L, L)
        cg_oracle = torch.einsum("...i,...j,ijk->...k", x1.double(), x2.double(),
                                 torch.as_tensor(cg_dense_numpy(L, L, L), device=device))
        routes = [("cg_full_tensor_product", lambda: cg_full_tensor_product(x1, x2, L, L, L),
                   cg_oracle),
                  (f"GauntTensorProduct[{tp.backend}]", lambda: tp(x1, x2), oracle),
                  ("ops.gaunt_tp_fused", lambda: gaunt_tp_fused(x1, x2, L, L, L,
                                                                device=device), oracle),
                  (f"plan pick[{p.backend}]", lambda: p.apply(x1, x2), oracle)]
        parts = []
        with torch.no_grad():
            for name, fn, want in routes:
                err, rel = rel_err(fn(), want)
                check(rel <= F32_IDENTITY_TOL, f"fig1a L={L}: {name} differs from its "
                                               f"dense oracle (rel {rel:.3e})")
                ms = event_ms(fn, reps=10 if L == 8 else 20) if device.type == "cuda" else None
                parts.append(f"{name} " + (f"{ms:.4f} ms" if ms is not None else "not timed")
                             + f" (rel err {rel:.2e})")
        print(f"[fig1a L={L}] [{rows}, {channels}, {d}] x2: " + "; ".join(parts)
              + f" (tol {F32_IDENTITY_TOL} against the f64 dense oracle of each product)")


def phase_conv_filter(device, Ls=(1, 2, 3, 4, 5, 6), edges: int = 1024, pinned_L: int = 4):
    """bench_engine's conv_filter sweep: the measured pick per L; then one
    plan pinned to the pair kernel against the eSCN plan."""
    import numpy as np
    import torch
    from repro_torch.core import engine as _engine
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats

    ge = _engine.get_engine()
    v = np.random.default_rng(3).normal(size=(edges, 3))
    rhat = torch.as_tensor(v / np.linalg.norm(v, axis=-1, keepdims=True), dtype=torch.float32,
                           device=device)
    for L in Ls:
        p = _engine.plan(L, L, L, kind="conv_filter", batch_hint=edges, tune="measure",
                         requires_grad=False, device=device)
        print_measured(f"conv L={L} B={edges}", ge, p.key, p.backend, device)
    L = pinned_L
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(edges, (L + 1) ** 2)),
                        dtype=torch.float32, device=device)
    pinned = _engine.plan(L, L, L, kind="conv_filter", backend="fused_hopper",
                          requires_grad=False, device=device)
    escn = _engine.plan(L, L, L, kind="conv_filter", backend="escn_aligned", device=device)
    reset_kernel_stats()
    with torch.no_grad():
        got = pinned.apply(x, rhat)
        want = escn.apply(x, rhat)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_stats()["gaunt_pair"]
    err, rel = rel_err(got, want)
    print(f"[conv] L={L} B={edges} pinned fused_hopper vs escn_aligned: max_abs_err "
          f"{err:.3e} rel {rel:.3e} (tol {F32_IDENTITY_TOL}), pair kernel launches {launches}")
    check(rel <= F32_IDENTITY_TOL, "the pinned conv_filter plan differs from escn_aligned")
    if device.type == "cuda":
        check(launches > 0, "the pinned conv_filter plan did not launch the pair kernel")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({SRC / 'repro_torch'}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff

    device = torch.device("cuda")
    cfg = dataclasses.replace(gaunt_mace_ff, chain_tune="measure", grid_gate="on")
    n_slots, max_atoms = 4, 32
    rows = n_slots * max_atoms * cfg.channels
    sizes = [8, 12, 16, 20, 24, 28, 32, 32, 10, 30]
    t_start = time.perf_counter()
    pair_rows = 640 * 128
    try:
        phase_device_and_build()
        max_abs_err = phase_kernel_vs_plain(device, rows)
        pair_err = phase_pair_vs_plain(device, pair_rows)
        launches, summ, model = phase_main_path(device, cfg, n_slots, max_atoms, sizes)
        kernel_ms, plain_ms, bound_ms, bound_by = phase_times(device, rows)
        step_ms = serve_step_ms(model, n_slots, max_atoms)
        print(f"[times] serve step (4 x 32 atoms, full width, forces): {step_ms:.2f} ms "
              f"host clock, median of 5")
        profile_step(model, n_slots, max_atoms)
        pair_launches, (x1, x2) = phase_pair_main(device, pair_rows)
        (pair_ms, pair_plain_ms, pair_bound_ms, pair_bound_by,
         pair_library_ms) = phase_pair_times(device, x1, x2)
        del x1, x2
        phase_fig1a(device)
        phase_conv_filter(device)
        check("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": [{
        "name": "gaunt_chain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gaunt_chain.cu",
        "replaces": "src/repro/kernels/gaunt_fused.py:122",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "gaunt_pair",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gaunt_pair.cu",
        "replaces": "src/repro/kernels/gaunt_fused.py:116",
        "launches": pair_launches,
        "max_abs_err": pair_err,
        "ms": pair_ms,
        "plain_ms": pair_plain_ms,
        "bound_ms": pair_bound_ms,
        "bound_by": pair_bound_by,
        "library_ms": pair_library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
