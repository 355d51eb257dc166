"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints no
result line):
  1. device and build — the card, torch/CUDA versions, the nvcc build of
     every kernel source (time and ptxas report);
  2. kernel vs plain — the Gaunt chain kernel against its plain PyTorch
     version on the card, forward and gradients, at the main-path shape
     and at the reference test chains (sh and grid entries/exits);
  3. main path — full-width `gaunt_mace_ff` (chain_tune='measure',
     grid_gate='on') served by `EquivariantServeEngine` (4 slots x 32 atoms)
     for seeded LJ clusters of 8-32 atoms: served == direct evaluation,
     finite, rotation invariant/equivariant, and the kernel launched;
  4. times — kernel and plain version (CUDA events per call, median of 50;
     device time from torch.profiler), the kernel's bound (counted at the
     grid's distinct sphere points, `sample_classes`), one serve step,
     and a profiled serve step (device busy time, idle share, top kernels).
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
    try:
        phase_device_and_build()
        max_abs_err = phase_kernel_vs_plain(device, rows)
        launches, summ, model = phase_main_path(device, cfg, n_slots, max_atoms, sizes)
        kernel_ms, plain_ms, bound_ms, bound_by = phase_times(device, rows)
        step_ms = serve_step_ms(model, n_slots, max_atoms)
        print(f"[times] serve step (4 x 32 atoms, full width, forces): {step_ms:.2f} ms "
              f"host clock, median of 5")
        profile_step(model, n_slots, max_atoms)
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
