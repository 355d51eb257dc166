"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints no
result line):
  1. device and build — the card, torch/CUDA versions, the nvcc build of
     every kernel source, all started together (time and ptxas report);
  2. kernels vs plain — the Gaunt chain kernel against its plain PyTorch
     version on the card, forward and gradients, at the main-path chain
     (gated and ungated) on every bucket's rows (2,048, 4,096 and 8,192:
     n_slots x max_atoms x channels of `default_buckets(32)`) and at the
     reference test chains (sh and grid entries/exits); the
     pair kernel against its plain version at the reference test shapes
     and at the full-width shape; then both again in their bf16 modes
     (`[kernel bf16]`, `[pair bf16]`: bf16 rows and T, f32 P and sums);
  3. main path — full-width `gaunt_mace_ff` (chain_tune='measure',
     grid_gate='on') served by the bucketed `EquivariantServeEngine`
     (`default_buckets(32)`: 8, 16 and 32 atoms, 4 slots each; each
     bucket's step a CUDA graph captured at warmup) for seeded LJ clusters
     of 8-32 atoms: per bucket the measured chain pick with both
     candidates' times, the capture time, graph memory and kernel launches
     per replay; served == direct evaluation, finite, rotation
     invariant/equivariant, the pick in the 32-atom bucket is the kernel
     and `gaunt_chain` launches are counted through the graph replays;
     each bucket's graph step against the eager `SlotPool.evaluate` on the
     same full slots (f32 identity tier); then a fresh engine fed only
     8-atom molecules never captures the 32-atom graph (`[small-only]`);
  4. times — chain kernel and plain version on the folded matrices the
     chain route uses (CUDA events per call, median of 50; device time
     from torch.profiler), the kernel's bound (counted at the grid's
     distinct sphere points, `sample_classes`), its registers and spills
     (ptxas); phase 3 again with the chain at compute_dtype='bfloat16'
     (`[main bf16]`: the measured pick in the 32-atom bucket must be the
     kernel, `gaunt_chain_bf16` launched, the served checks at the bf16
     tiers; the bf16 chain kernel's times and bound at bf16 bytes); then,
     per bucket and storage, the graph step against the eager step in
     turns (`[times] serve ... bucket ...`: stage, run, host copy; median
     of 21 on the host clock and with CUDA events), one serve step through
     the engine, a profiled graph step and a profiled eager step per
     storage (device busy time, idle share, GPU events, top kernels), each
     bucket's step captured with each chain candidate pinned and replayed
     (`[pick]`: is the eager pick still the faster chain in a graph?), and
     two replicas with their own graphs behind one scheduler, replica0
     failing every step and cordoned, its requests served by replica1
     (`[replicas]`: graph memory per replica, failovers, energies ==
     direct);
  4a. autotune cache — the engine's measurements flushed to a cache file,
     the engine cleared, and a fresh serve engine with
     ``cfg.autotune_cache`` set to the file: zero timing runs in warmup,
     every bucket's pick as measured, served == direct; a corrupt file and
     the injected ``autotune_cache_load`` fault each measure cold, count
     ``autotune_cache_load_failed`` and still serve (`[autotune]`);
  4b. training — full-width `gaunt_mace_ff` (f32, measured chain, grid gate
     on) trained by `train_loop` (AdamW + cosine, clip 10, checkpoints) for
     24 steps on seeded LJ batches of 8 clusters of 16 atoms (8,192 chain
     rows a layer): every loss printed, finite and falling, the measured
     pick the kernel with one `gaunt_chain` launch a layer and step, the
     loss and gradients of a kernel-pinned step against a tree-pinned one,
     a run preempted at step 12 and resumed from its checkpoint against the
     uninterrupted run, the trained model's rotation symmetry, 3 steps with
     the chain at bf16 (`gaunt_chain_bf16`); the step time, peak memory,
     each pinned candidate's step time and a profiled step (`[train]`);
  4c. the other equivariant models — `gaunt_segnn_nbody` at full width on
     100 charged N-body systems (80,000 chain rows a layer, the resident
     edge product measured with a Fourier entry): finite, equivariant,
     kernel- vs tree-pinned forward and gradients, one `gaunt_chain` launch
     a layer, the quadrature gate, 40 SGD steps on the kernel and 40 with
     CG, a profiled step (`[segnn]`); `SelfmixLayer` at
     `gaunt_equiformer_selfmix`'s width on 2,560 nodes (81,920 rows), and
     again at the EquiformerV2 cell's key (L=6, 128 channels, 1,376 nodes,
     176,128 rows): the measured shared-operand key, every route's product
     branch against the tree's, one launch a pinned call, times per route,
     bf16 and 'auto' (`[selfmix]`, `[times] selfmix`); `EquiformerV2Gaunt`
     at its OC20 widths served on
     one bucket of 86 atoms x 16 slots as a graph, against the plain
     float64 reference, with its launches per replay and step time
     (`[equiformer]`); `plan_batch` buckets on the pair kernel (one launch
     per bucket) and Fourier-boundary buckets (`[batched]`); the measured
     gate policy at every serve bucket, `gaunt_mace_ff` with
     grid_gate='auto' served == direct, and this run's autotune file
     reloaded with zero timing runs (`[policies]`);
  4d. the paper's general convolution — full-width `gaunt_mace_ff` with
     conv_impl='general' (the filter Y(r) on its Fourier grid once per
     geometry, a direct 2D convolution a layer) served through the same
     buckets, each step a CUDA graph: served == direct, general == eSCN at
     the same parameters, rotation, one chain launch a layer a replay,
     each bucket's graph and eager step against [main]'s eSCN step, a
     profiled 32-atom graph step, a fresh engine warm from the phase's
     autotune file, 6 `train_loop` steps and a kernel- vs tree-pinned step
     (`[general]`; the direct conv's forward and adjoint launches a layer
     in each graph and through the replays); the direct conv's kernel pair
     against its plain versions at odd shapes (generic kernels and
     complex128 too) and at the served shape, forward, both adjoints and
     the double backward, then its device times against the bound, the
     plain shift-and-add and the fft route (`[direct]`, `[times] direct
     conv`; the kernels line's `direct_conv` launches are the served
     general run's forward and adjoint launches); `plan(kind='manybody')`
     on each of its five backends at 8,192 rows against the tree chain,
     forward and gradients, ms a call,
     and `plan_batch` with two Ls buckets (`[manybody]`); `calibrate_fused`
     at f32 and bf16, reloaded measured, and the offline `--fast` sweep
     then `--verify-warm` with zero timing runs (`[calibrate]`); the
     quickstart twin on the card (`[quickstart]`);
  5. pairwise path — the pairwise tensor product `ops.gaunt_tp_fused` at
     (L1, L2, Lout) = (6, 6, 6) on 81,920 rows (EquiformerV2's OC20 width,
     lmax 6 x 128 channels, 640 nodes): the pair kernel launched, finite,
     equal to the dense oracle on a row subset, equivariant, and timed
     against its plain version, its bound (the exact algorithm with the
     fewest operations) and the dense Gaunt contraction in library calls,
     with its tensor-core rate and registers (ptxas); then the same at
     bf16 storage (`[pairwise bf16]`, `gaunt_pair_bf16`, bf16 tiers);
  6. Fig. 1(a) sweep — `plan(L, L, L, batch_hint=512, tune='measure')` on
     [4, 128, (L+1)^2] operands for L in 1..6 and 8: every candidate's
     time and the pick, the CG baseline, `GauntTensorProduct` and
     `ops.gaunt_tp_fused`, each against its dense oracle;
  7. conv_filter sweep — the measured `conv_filter` pick for L in 1..6 at
     1024 edges, and a plan pinned to the pair kernel against
     `escn_aligned`;
  8. WKV6 kernel vs plain — `wkv6_hopper` against `wkv6_chunked`, output
     and final state, at the reference's kernel-test shapes, T < 64, K = V =
     64 in f32 and in bf16 (r, k, v as the model feeds them), 32 chunks on
     2 (b, h) (the state pass's loop on few blocks), decay 0.999 and 1e-6,
     and the full-width shape [4, 2048, 40, 64];
  9. the RWKV6 slice — `rwkv6-3b` at its published widths and full depth
     (32 layers, 3.1e9 f32 parameters, bf16 compute) on random weights from
     a seeded generator on the card: prefill 4 x 2048 tokens (the WKV kernel
     launched once per layer), 16 greedy decode steps, finite logits and
     state, decode after a 256-token prefill against forward's logits at
     the next position (f32 compute at full depth, bf16 at 2 layers), and
     the kernel against its plain version on the first layer's WKV inputs;
  10. RWKV6 times — the WKV kernel (both passes, and each pass) and its
     plain version at full width on layer 0's inputs in the model's dtypes,
     the kernel on f32 copies of r, k, v beside (bound: the sequential
     recurrence's operations, the bytes at the dtypes read), prefill and
     decode per token on the host clock, and a profiled prefill;
  11. SSD kernel vs plain — `mamba2_ssd_hopper` against
     `mamba2_ssd_chunked`, output and final state, at the reference's
     kernel-test shapes (G = 2), T < 64, strong (A = -8, dt up to 5) and
     weak (A dt ~ -1e-4) decay, 32 chunks on 2 (b, h) (the state pass's
     chunk chain at full depth), and the full-width shape [4, 2048, 80, 64]
     (N 64, G 1, bf16 x, B and C as the model feeds them);
  12. the Zamba2 slice — `zamba2-2.7b` at its published widths and full
     depth (54 Mamba-2 layers in 9 stages of 6 plus the shared attention
     block, 2.44e9 f32 parameters, bf16 compute) on random weights from a
     seeded generator on the card, after the RWKV6 parameters are freed:
     prefill 4 x 2048 tokens (the SSD kernel launched once per Mamba-2
     layer: 54), 16 greedy decode steps, finite logits and state, decode
     after a 256-token prefill against forward over 320 tokens read at 256
     (f32 compute at 54 layers, bf16 at one stage of 6; bf16 at 54
     printed), and the kernel against its plain version on the first
     layer's SSD inputs;
  13. Zamba2 times — the SSD kernel (both passes, and each pass: state
     pass, output pass) and its plain version at full width on layer 0's
     inputs (bound: the step recurrence's operations), prefill and decode
     per token on the host clock, and a profiled prefill (its SSD share
     sums both passes);
  14. LM serving — RWKV6-3B (after phase 10) and Zamba2-2.7B (after phase
     13) served through the LM `ServeEngine` while their weights are
     loaded, then, each built from `torch.Generator(device).manual_seed(0)`
     over f32 weights and freed before the next: `qwen2-0.5b` at full width
     and depth, the main path (8 requests of 16-64 prompt tokens, 16 new
     tokens, 4 slots, max_len 512, bf16 compute), and `qwen2-moe-a2.7b` at
     full width and depth (57 GB of f32 weights; 4 requests).  For each
     model the engine's decode step is a CUDA graph captured at warmup and
     replayed for every decode step and prompt token; an eager engine
     serves the same requests: identical tokens, and one step from the
     same cache gives the same logits and cache (`[lmserve]`); the decode
     step per token as a graph and eager in turns (host clock, median of
     21), the served tokens/s, a profiled step of each.  qwen2-0.5b's
     served tokens at f32 compute against the teacher-forced greedy argmax
     of `forward`; the MoE's decode after a 2 x 256 prefill against
     `forward` at f32, at capacity_factor 8.0 (printed) and at a capacity
     where no entry can drop (held to the f32 tier);
  15. the attention families at full width (`[lmfamilies]`), a depth cut
     only where 80 GB forces one: gemma-2b, stablelm-3b, whisper-base (1,500
     source frames), qwen1.5-32b (8 of 64 layers), qwen2-vl-72b (4 of 80,
     3-axis positions3), dbrx-132b (2 of 40): a 2 x 256 prefill and 4
     decode steps, each against `forward` at f32; the same at bf16 compute,
     the served dtype, over the same weights (bf16 tier), and the bf16
     forward against the f32 forward per token (bf16 loose tier): gemma-2b
     held on its first 6 layers (its full depth printed), dbrx-132b's
     parted tokens each after a near tie of its router (the rule of
     tests/test_torch_lm_bf16.py) and at most 4 in 64; gemma-2b's int8 KV cache
     against its f32 cache over 16 greedy tokens (the quantizer's bound on
     the prefilled rows, any parting of the streams a near tie);
  16. LM training (`[lmtrain]`) — RWKV6-3B after its serving phase and
     Zamba2-2.7B after its, at full width and depth with their loaded
     weights: 3 AdamW steps at 1 x 2048 tokens (bf16 compute, remat on)
     through `make_train_step` on `LMModule`, the scan kernel launched once
     a layer in the forward and once in remat's recompute, the step time,
     peak memory, a profiled step and the plain scan backward's share of
     its busy time, then at 2 layers and f32 compute the kernel route's
     loss gradients against the all-plain route's; after the attention
     families, `qwen2-0.5b` (the slice's main path) at full width and
     depth: `train_loop` on `LMTokenPipeline` batches of 2 x 2048 tokens
     (flash attention on 2 x 2 tiles), 3 steps with a checkpoint, a fresh
     module resumed from it to step 6, then the step time (median of 5
     after 2 warm), peak memory, a profiled step and the model-flops share
     of the dense bf16 peak; the flash backward at its attention shape, f32
     and bf16, against autograd through full attention, with each route's
     peak memory.  The kernels line's `wkv6` and `mamba2_ssd` launches
     count the prefill's and the training steps';
  17. distribution (`[dist]`, last) — a world-size-1 NCCL process group
     through a FileStore in a temporary directory (a failed init fails the
     run), `make_host_mesh(1, 1)` on cuda, full-width `gaunt_mace_ff` with
     ``shard_data=True`` on the activation mesh against ``shard_data=False``
     (energy and forces of a 32-atom cluster; the first three sharded
     calls timed alone, and the 'model' group's first collective),
     `plan_chain(backend=
     'fused_hopper', shard_spec=ShardSpec(mesh))` at 8,192 rows against the
     unsharded kernel call, a pinned sharded pair-kernel bucket (6, 6, 6) x
     81,920 rows, six `train_loop` steps of RWKV6-3B at full width
     (4 of 32 layers, 1 x 2048 tokens) with ``mesh`` and ``shardings``
     (weights gathered layer by layer) against the unsharded run's
     losses, and `int8_ef_cross_pod_mean` on a
     (1, 1, 1) ('pod', 'data', 'model') mesh against the plain formula.
     One card shows no collective between two ranks (the CPU tests hold the
     two-rank arithmetic with gloo).  The kernels line's `gaunt_chain`,
     `gaunt_pair` and `wkv6` launches add this phase's.
The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.  Needs no network and imports no JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
BF16_IDENTITY_TOL = 5e-2  # bf16 "identity" tier (the LM path computes in bf16)
BF16_TRANSFORM_TOL = 7e-2  # bf16 "transform" tier
BF16_LOOSE_TOL = 1.2e-1    # bf16 "loose" tier
# (identity, transform, loose) per storage dtype: repro/testing/precision.py
TIERS = {"float32": (F32_IDENTITY_TOL, F32_TRANSFORM_TOL, F32_LOOSE_TOL),
         "bfloat16": (BF16_IDENTITY_TOL, BF16_TRANSFORM_TOL, BF16_LOOSE_TOL)}
# a bf16-mode Gaunt kernel against its plain version: both read the same
# bf16 values, form exact f32 products and sum in f32, only in another
# order.  Gradients that come back at bf16 (dx_i, cast to its operand's
# dtype as in the reference) may round to neighbouring bf16 values from
# f32 sums that differ in the last bits, so they are held to one bf16 unit
# in the last place per element (2^-7 of the element).
BF16_KERNEL_TOL = 1e-5
BF16_ULP = 2.0 ** -7
# the pair kernel against its plain version: both are f32 sums of the same
# products, only in another order, so they agree to a few f32 roundings
PAIR_VS_PLAIN_TOL = 1e-5
PAIR_EQUIVARIANCE_TOL = 1e-5
# the SSD kernel against its plain version: both are f32 chunked sums with
# la summed in the same order, so they agree far inside the f32 tier
SSD_VS_PLAIN_TOL = 1e-4


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


# ptxas's report of each source built in this run (`phase_device_and_build`)
BUILD_LOGS: dict = {}


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
        BUILD_LOGS[r.name] = r.log
        print(f"[build] {r.name}: nvcc {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")


def ptxas_report(log: str) -> list:
    """[(entry function, registers, spill store bytes, spill load bytes)]
    from ``nvcc -Xptxas -v`` output."""
    import re

    rows, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            rows.append((entry, int(m.group(1)), *spills))
            entry = None
    return rows


def print_registers(tag: str, name: str) -> None:
    """The registers and spills ptxas reported for source ``name`` in this
    run's build."""
    rows = ptxas_report(BUILD_LOGS.get(name, ""))
    if not rows:
        print(f"[times] {tag} registers: not reported (no build log in this run)")
    for entry, regs, st, ld in rows:
        print(f"[times] {tag} {entry}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B (ptxas -v, this run's build)")


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


def bf16_grad_err(got, ref) -> float:
    """The largest elementwise error of bf16-valued gradients in units of
    one bf16 ulp bound (2^-7 |ref|, and 1e-5 of the scale near zero): <= 1
    means every element is within one bf16 rounding of the reference."""
    got, ref = got.double(), ref.double()
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    allow = BF16_ULP * ref.abs() + BF16_KERNEL_TOL * scale
    return float(((got - ref).abs() / allow).max()) if ref.numel() else 0.0


def compare_chain(Ls, Lout, entries, out_entry, B, gated, device, seed=0, dtype="float32"):
    """Forward and gradients of the kernel route vs the plain route on the
    same inputs at storage ``dtype`` -> (forward abs err, forward rel err,
    grad rel err of the f32 gradients, worst bf16-valued gradient error in
    bf16 ulps (`bf16_grad_err`; 0 at f32 storage))."""
    import torch
    from repro_torch.kernels.gaunt_fused import (gaunt_chain_fused_hopper,
                                                 gaunt_chain_fused_torch)

    results = []
    for fn in (gaunt_chain_fused_hopper, gaunt_chain_fused_torch):
        xs, gate = _chain_inputs(Ls, entries, B, gated, device, seed)
        leaves = [x.requires_grad_(True) for x in xs]
        if gate is not None:
            leaves += [g.requires_grad_(True) for g in gate]
        out = fn(xs, Ls, Lout, entries=entries, out_entry=out_entry, gate=gate, dtype=dtype)
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
    grel = gulp = 0.0
    n_ops = len(Ls)
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        if dtype == "bfloat16" and i < n_ops:
            gulp = max(gulp, bf16_grad_err(a, b))  # dx_i comes back at bf16
        else:
            grel = max(grel, rel_err(a, b)[1])
    return err, rel, grel, gulp


CHAIN_CASES = [
    ((2, 2, 2), 2, ("sh",) * 3, "sh", None, True),   # None: each bucket's rows
    ((2, 2, 2), 2, ("sh",) * 3, "sh", None, False),
    ((1, 1), 2, ("sh", "sh"), "sh", 257, False),
    ((1, 1), 2, ("sh", "sh"), "grid", 257, True),
    ((2, 1, 2), 3, ("grid", "sh", "sh"), "sh", 300, True),
    ((2, 1, 2), 3, ("sh", "grid", "sh"), "sh", 300, False),
    ((1, 2, 1, 2), 4, ("sh",) * 4, "sh", 129, True),
    ((1, 2, 1, 2), 6, ("sh", "sh", "grid", "sh"), "grid", 129, False),
    # the other models' chains at their full-width rows: SEGNN's resident
    # edge product (100 N-body systems x 5 x 5 pairs x 32 channels) and
    # EquiformerV2's Selfmix (2,560 nodes x 32 channels; dsum 50, dout 25:
    # the launch past 48 KB of shared memory)
    ((1, 1), 1, ("sh", "grid"), "sh", 80000, False),
    ((4, 4), 4, ("sh", "sh"), "sh", 81920, False),
]
# the cases whose errors stand for the kernel's main paths in the record
MAIN_CHAIN_ROWS = (80000, 81920)


def phase_kernel_vs_plain(device, bucket_rows, dtype: str = "float32"):
    """Main-path chain (gated and ungated) at each bucket's rows
    (``bucket_rows``: the rows of every bucket's step), then the reference's
    test chains with 'grid' entries and exits and the SEGNN and Selfmix
    chains at their full-width rows, at storage ``dtype``: f32
    within the f32 tiers; bf16 (the kernel's bf16 mode) forward and f32
    gradients within `BF16_KERNEL_TOL`, bf16 gradients within one bf16 ulp.
    -> the largest main-path max abs error."""
    main_err = 0.0
    cases = [(i, case[:4] + (rows,) + case[5:])
             for i, case in enumerate(CHAIN_CASES) if case[4] is None for rows in bucket_rows]
    cases += [(i, case) for i, case in enumerate(CHAIN_CASES) if case[4] is not None]
    for i, (Ls, Lout, entries, out_entry, B, gated) in cases:
        err, rel, grel, gulp = compare_chain(Ls, Lout, entries, out_entry, B, gated, device,
                                             seed=i, dtype=dtype)
        if dtype == "bfloat16":
            ok = rel <= BF16_KERNEL_TOL and grel <= BF16_KERNEL_TOL and gulp <= 1.0
            tol = (f"(tol {BF16_KERNEL_TOL}), f32 grad rel {grel:.3e} (tol "
                   f"{BF16_KERNEL_TOL}), bf16 dx within {gulp:.3f} bf16 ulp (tol 1)")
        else:
            ok = rel <= F32_IDENTITY_TOL and grel <= F32_LOOSE_TOL
            tol = (f"(tol {F32_IDENTITY_TOL}), grad rel {grel:.3e} (tol {F32_LOOSE_TOL})")
        tag = "kernel" if dtype == "float32" else "kernel bf16"
        print(f"[{tag}] Ls={Ls} Lout={Lout} entries={entries} exit={out_entry} "
              f"B={B} gated={gated}: fwd max_abs_err {err:.3e} rel {rel:.3e} {tol} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain version for Ls={Ls} B={B} at {dtype}")
        if CHAIN_CASES[i][4] is None or B in MAIN_CHAIN_ROWS:
            main_err = max(main_err, err)
    return main_err


PAIR_CASES = [(1, 1, 2), (2, 2, 4), (3, 2, 3), (4, 4, 8), (6, 6, 6), (6, 6, 12),
              (8, 8, 8), (8, 8, 16), (4, 4, 4)]   # (4, 4, 4): a `[batched]` bucket
PAIR_MAIN = (6, 6, 6)


def _pair_rows(L1, L2, B, device, seed, dtype="float32"):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=(B, (L + 1) ** 2)), dtype=torch.float32,
                                 device=device).to(getattr(torch, dtype)) for L in (L1, L2))


def phase_pair_vs_plain(device, main_rows: int, dtype: str = "float32") -> float:
    """The pair kernel (`launch_pair_kernel`, through `gaunt_fused_hopper`)
    against `pair_plain` on the same rows and folded matrices at storage
    ``dtype``: every shape of `PAIR_CASES` at 1, 7, 300 and 4099 rows (a
    ragged last block, and dout split over blocks from (4, 4, 8) on), and
    the full-width shape at ``main_rows``; -> max abs error at the
    full-width shape."""
    import torch
    from repro_torch.core import constants as _c
    from repro_torch.kernels.gaunt_fused import gaunt_fused_hopper, pair_plain

    bf16 = dtype == "bfloat16"
    why = ("bf16 x bf16 products exact in f32, f32 sums in another order, 3xTF32 "
           "projection" if bf16 else
           "3xTF32 keeps 22 of each operand's 24 bits, sums in another order")
    main_err = 0.0
    for i, (L1, L2, Lout) in enumerate(PAIR_CASES):
        rows = [1, 7, 300, 4099] + ([main_rows] if (L1, L2, Lout) == PAIR_MAIN else [])
        T1, T2, _ = _c.pair_matrices(L1, L2, Lout, dtype=dtype)
        P = _c.pair_matrices(L1, L2, Lout)[2]
        sdt = torch.bfloat16 if bf16 else None
        mats = [_c.to_torch(T1, device, sdt), _c.to_torch(T2, device, sdt),
                _c.to_torch(P, device)]
        for B in rows:
            x1, x2 = _pair_rows(L1, L2, B, device, seed=10 * i + B, dtype=dtype)
            with torch.no_grad():
                got = gaunt_fused_hopper(x1, x2, L1, L2, Lout)
                want = pair_plain(x1, x2, *mats)
            if device.type == "cuda":
                torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            ok = rel <= PAIR_VS_PLAIN_TOL and bool(torch.isfinite(got).all())
            print(f"[pair{' bf16' if bf16 else ''}] (L1,L2,Lout)=({L1},{L2},{Lout}) B={B} "
                  f"G={mats[0].shape[1]}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
                  f"{PAIR_VS_PLAIN_TOL}: {why}) {'ok' if ok else 'FAIL'}")
            check(ok, f"pair kernel disagrees with its plain version at "
                      f"({L1},{L2},{Lout}) B={B} ({dtype})")
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


def _bucket_key(ge, cfg, pool, device, dtype=None):
    """The measured chain key a bucket's step asks: every slot in one pass,
    the fused gate."""
    return ge.chain_measure_key((cfg.L,) * cfg.nu, cfg.L, dtype or cfg.compute_dtype,
                                pool.spec.n_slots * pool.spec.max_atoms * cfg.channels,
                                (0,) * cfg.nu, True, device)


def fill_pool(pool, n_species, seed):
    """Fill every slot of ``pool`` with a seeded LJ cluster of the bucket's
    full size (host writes only)."""
    for r in make_requests([pool.spec.max_atoms] * pool.spec.n_slots, n_species, seed):
        check(pool.admit(r), f"no free slot in bucket {pool.spec.label()}")


def served_vs_direct(model, reqs, device) -> tuple[float, float]:
    """Each served request against a direct evaluation of its molecule alone
    -> (worst energy error relative to max(1, |E|), worst force error
    relative to max|F|); fails on a non-finite or misshapen result."""
    import numpy as np
    import torch

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
    return worst_e, worst_f


def _timing_share(ge, before: dict) -> str:
    """Host seconds the engine spent timing each chain candidate since
    ``before`` (a copy of `GauntEngine.chain_timing_s`)."""
    spent = {k: v - before.get(k, 0.0) for k, v in ge.chain_timing_s.items()}
    return ("timing the chain candidates: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in spent.items() if v > 0) if any(
        v > 0 for v in spent.values()) else "no chain candidate timed")


def phase_main_path(device, cfg, buckets, sizes):
    """The served force field at ``cfg`` through the bucketed engine (its
    compute_dtype sets the chain's storage, the kernel mode counted and the
    tolerance tiers): each bucket's step is a captured CUDA graph."""
    import numpy as np
    import torch
    from repro_torch.core import engine as _engine
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantServeEngine

    bf16 = cfg.compute_dtype == "bfloat16"
    tag = "main bf16" if bf16 else "main"
    stat = "gaunt_chain_bf16" if bf16 else "gaunt_chain"
    tol_id, tol_tr, tol_loose = TIERS[cfg.compute_dtype]
    model = MaceGaunt(cfg, device=device, generator=torch.Generator().manual_seed(0))
    eng = EquivariantServeEngine(model, buckets=buckets)
    ge = _engine.get_engine()
    spent = dict(ge.chain_timing_s)
    t0 = time.perf_counter()
    eng.warmup()
    print(f"[{tag}] warmup {time.perf_counter() - t0:.2f} s (buckets "
          + ", ".join(f"{p.spec.label()} {p.spec.n_slots} x {p.spec.max_atoms} atoms, "
                      f"{p.spec.n_slots * p.spec.max_atoms * cfg.channels} chain rows"
                      for p in eng.pools) + f"; chain storage {cfg.compute_dtype}); "
          + _timing_share(ge, spent))
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    picks = {}
    for pool in eng.pools:
        key = _bucket_key(ge, cfg, pool, device)
        times, spread = ge.measured_times[key], ge.measured_spread[key]
        pick = picks[pool.spec.label()] = min(times, key=times.get)
        print(f"[{tag}] bucket {pool.spec.label()}: measured chain rows={key[3]} gate=True "
              f"({clock} per eager call, host launches included, median of "
              f"{_engine._MEASURE_REPS}, [min, max]): "
              + ", ".join(f"{k} {v * 1e3:.4f} ms [{spread[k][0] * 1e3:.4f}, "
                          f"{spread[k][1] * 1e3:.4f}]" for k, v in times.items())
              + f" -> {pick}")
        if device.type == "cuda":
            check(pool.compiled() and pool.graph_bytes is not None,
                  f"bucket {pool.spec.label()}: no graph after warmup")
            print(f"[{tag}] bucket {pool.spec.label()}: graph captured in "
                  f"{pool.capture_s * 1e3:.1f} ms, graph memory {pool.graph_bytes / 2**20:.1f} "
                  f"MiB, kernel launches per replay {pool.launches or '{}'}")
    reqs = make_requests(sizes, cfg.n_species, seed=100)
    replays = [p.replays for p in eng.pools]
    reset_kernel_stats()
    t0 = time.perf_counter()
    eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_stats()[stat]
    summ = eng.metrics.summary()
    per_bucket = {p.spec.label(): (p.replays - r0, p.launches.get(stat, 0) * (p.replays - r0))
                  for p, r0 in zip(eng.pools, replays)}
    print(f"[{tag}] served {len(reqs)} requests ({sum(sizes)} atoms) in {wall:.3f} s, "
          f"{summ['steps']} steps, step p50 {summ['step_p50_ms']:.2f} ms, "
          f"{stat} launches {launches} (counted through graph replays; per bucket "
          f"(replays, launches): {per_bucket})")
    check(all(r.done and not r.rejected for r in reqs), "a request did not complete")
    check(summ["engine_timing_runs"] == ge.timing_runs, "timing runs are not surfaced")
    worst_e, worst_f = served_vs_direct(model, reqs, device)
    print(f"[{tag}] served vs direct: energy rel {worst_e:.3e} (tol {tol_id}), "
          f"forces rel {worst_f:.3e} (tol {tol_loose})")
    check(worst_e <= tol_id, "served energy differs from direct evaluation")
    check(worst_f <= tol_loose, "served forces differ from direct evaluation")
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
    print(f"[{tag}] rotation: energy rel {de:.3e} (tol {tol_tr}), forces rel "
          f"{df:.3e} (tol {tol_loose}); |E| {abs(float(e0)):.4e} max|F| "
          f"{float(np.abs(f0).max()):.4e}")
    check(de <= tol_tr and df <= tol_loose, "rotation check failed")
    large = eng.pools.pools[-1]
    served_pick = picks[large.spec.label()]
    print(f"[{tag}] served chain backend in the {large.spec.max_atoms}-atom bucket: "
          f"{served_pick}")
    kernel = "fused_hopper" if device.type == "cuda" else "fused_torch"
    check(served_pick == kernel, f"the measured pick for the served chain is "
                                 f"{served_pick!r}, not the kernel")
    if device.type == "cuda":
        check(per_bucket[large.spec.label()][1] > 0,
              f"the chain kernel ({stat}) was not launched by the "
              f"{large.spec.max_atoms}-atom bucket's graph replays")
        check(launches == sum(n for _, n in per_bucket.values()),
              f"{stat} launches {launches} differ from the graphs' replays {per_bucket}")
    # each bucket's graph step against the eager step on the same full slots
    for pool in eng.pools:
        fill_pool(pool, cfg.n_species, seed=300 + pool.spec.max_atoms)
        pool.stage()
        e, f = (t.clone() for t in pool.step_staged())
        e0, f0 = pool.evaluate(pool.species, pool.pos, pool.mask)
        de, de_rel = rel_err(e, e0)
        df = float((f - f0).abs().max())
        df_rel = df / max(1e-30, float(f0.abs().max()))
        print(f"[{tag}] bucket {pool.spec.label()}: graph step vs eager evaluate, "
              f"{pool.spec.n_slots} x {pool.spec.max_atoms} atoms: energy max abs "
              f"{de:.3e} (rel {de_rel:.3e}), forces max abs {df:.3e} (rel {df_rel:.3e}); "
              f"tol {F32_IDENTITY_TOL}")
        check(de_rel <= F32_IDENTITY_TOL and df_rel <= F32_IDENTITY_TOL,
              f"bucket {pool.spec.label()}: the graph step differs from the eager step")
        pool.evict()
    return launches, model, eng


def phase_small_only(model, buckets):
    """A fresh engine fed only molecules of the smallest bucket's size never
    captures a larger bucket's graph."""
    from repro_torch.serve.engine import EquivariantServeEngine

    eng = EquivariantServeEngine(model, buckets=buckets)
    small, large = eng.pools.pools[0], eng.pools.pools[-1]
    reqs = make_requests([small.spec.max_atoms] * 6, model.cfg.n_species, seed=700)
    eng.run(reqs)
    check(all(r.done and not r.rejected for r in reqs), "a small-only request did not complete")
    built = {p.spec.label(): p.compiled() for p in eng.pools}
    print(f"[small-only] {len(reqs)} molecules of {small.spec.max_atoms} atoms: buckets "
          f"built {built}, replays {[p.replays for p in eng.pools]}")
    check(small.compiled(), "the small bucket served without its step")
    check(not large.compiled() and large.replays == 0,
          f"a small-only workload captured the {large.spec.max_atoms}-atom bucket's graph")


def _step_times(fn):
    """(host ms, CUDA-event ms) of one call of ``fn`` that ends in a host
    copy; the event pair brackets the call on the current stream."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return (time.perf_counter() - t0) * 1e3, a.elapsed_time(b)


def phase_graph_times(eng, tag, reps: int = 21):
    """Graph step against eager step, per bucket, in one process and in
    turns (graph, eager, eager, graph, ...): each step stages the slots,
    runs, and copies energies and forces to the host.  Medians of ``reps``
    on the host clock and with CUDA events.  Returns {bucket: (graph host,
    graph events, eager host, eager events)}."""
    import numpy as np

    out = {}
    for pool in eng.pools:
        fill_pool(pool, eng.model.cfg.n_species, seed=800 + pool.spec.max_atoms)

        def graph():
            pool._dirty = True
            pool.stage()
            e, f = pool.step_staged()
            e.cpu(), f.cpu()

        def eager():
            e, f = pool.evaluate(pool.species, pool.pos, pool.mask)
            e.cpu(), f.cpu()

        graph(), eager()
        g, x = [], []
        for k in range(reps):
            order = ((graph, g), (eager, x)) if k % 2 == 0 else ((eager, x), (graph, g))
            for fn, acc in order:
                acc.append(_step_times(fn))
        gh, ge_ = (float(np.median([t[i] for t in g])) for i in (0, 1))
        xh, xe = (float(np.median([t[i] for t in x])) for i in (0, 1))
        out[pool.spec.label()] = (gh, ge_, xh, xe)
        print(f"[times] {tag} bucket {pool.spec.label()} ({pool.spec.n_slots} x "
              f"{pool.spec.max_atoms} atoms, forces, host copy included): graph step "
              f"{gh:.3f} ms host / {ge_:.3f} ms events, eager step {xh:.3f} ms host / "
              f"{xe:.3f} ms events (median of {reps}, in turns); eager / graph x{xh / gh:.2f} "
              f"host")
        pool.evict()
    return out


def phase_replicas(device, cfg, buckets):
    """Two replicas behind one scheduler, each with its own captured graphs;
    replica0 fails every step, is cordoned, and its requests complete on
    replica1 with the direct numbers."""
    import numpy as np
    import torch
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantServeEngine
    from repro_torch.serve.faults import FaultPlan, injected
    from repro_torch.serve.replicas import ReplicaSet

    model = MaceGaunt(cfg, device=device, generator=torch.Generator().manual_seed(0))

    def factory(i, metrics):
        return EquivariantServeEngine(model, buckets=buckets, metrics=metrics,
                                      tag=f"replica{i}", warmup=True)

    rset = ReplicaSet(factory, n_replicas=2, max_fail_streak=2, restart_backoff_s=60.0)
    for r in rset.replicas:
        mem = sum(p.graph_bytes or 0 for p in r.engine.pools)
        print(f"[replicas] {r.name}: {sum(p.graph_bytes is not None for p in r.engine.pools)} "
              f"graphs captured, graph memory "
              f"{mem / 2**20:.1f} MiB ("
              + ", ".join(f"{p.spec.label()} {(p.graph_bytes or 0) / 2**20:.1f}"
                          for p in r.engine.pools) + ")")
    sizes = [b.max_atoms for b in buckets] + [b.max_atoms - 1 for b in buckets]
    reqs = make_requests(sizes, cfg.n_species, seed=1000)
    for r in reqs:
        r.max_retries = 10
    plan = FaultPlan(seed=0, rates={"step_raise": 1.0},
                     scope=lambda ctx: ctx.get("tag") == "replica0")
    with injected(plan):
        rset.run(reqs)
    m = rset.metrics.summary()
    check(all(r.done and not r.rejected for r in reqs), "a request was lost in failover")
    check(m["failovers"] >= 1 and not rset.replicas[0].live,
          "the failing replica was not cordoned")
    worst = 0.0
    for r in reqs:
        e, _ = model.energy_forces(torch.as_tensor(r.species, device=device),
                                   torch.as_tensor(r.pos, device=device))
        worst = max(worst, abs(r.energy - float(e)) / max(1.0, abs(float(e))))
    print(f"[replicas] replica0 failing every step: failovers {m['failovers']}, requeued "
          f"{m['requeued_on_failover']}, step failures {m['step_failures']}, all "
          f"{len(reqs)} served by replica1; energy vs direct rel {worst:.3e} "
          f"(tol {F32_IDENTITY_TOL}); completion order {list(rset.metrics.completed_order)}")
    check(worst <= F32_IDENTITY_TOL, "failed-over energies differ from direct evaluation")
    check(np.all([r._replica == 1 for r in reqs]), "a request finished on the cordoned replica")


# --------------------------------------------------------------------------
# the persistent autotune cache, and force-field training
# --------------------------------------------------------------------------


def _chain_keys(ge, cfg, buckets, device, dtype="float32"):
    """Every chain key a warmup of ``buckets`` seeds at ``dtype``: per bucket
    its step's rows, gated and ungated (grid_gate='on')."""
    return [ge.chain_measure_key((cfg.L,) * cfg.nu, cfg.L, dtype,
                                 spec.n_slots * spec.max_atoms * cfg.channels,
                                 (0,) * cfg.nu, gate, device)
            for spec in buckets for gate in (False, True)]


def phase_autotune(device, cfg, buckets, sizes):
    """The persistent autotune cache finishing serving: the engine's
    measurements flushed to a file, the engine cleared, and a fresh serve
    engine configured with that file warms up with zero timing runs, the
    same pick in every bucket, and serves as direct evaluation does.  Then
    a corrupt file, and the injected ``autotune_cache_load`` fault, each
    measure cold, count their degradation and still serve."""
    import os
    import tempfile

    import torch
    from repro_torch.core import autotune_cache
    from repro_torch.core import engine as _engine
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantServeEngine
    from repro_torch.serve.faults import FaultPlan, injected

    ge = _engine.get_engine()
    keys = _chain_keys(ge, cfg, buckets, device)
    first = {k: ge.measured_pick(k) for k in keys}
    check(all(first.values()), f"a bucket's chain key was never measured: {first}")
    fp = autotune_cache.fingerprint()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        ge.set_autotune_cache(path)
        ge.flush_autotune_cache()
        with open(path) as f:
            n_sel = len(json.load(f)["selections"])
        print(f"[autotune] flushed {n_sel} measured selections to the cache file "
              f"(fingerprint: torch {fp['torch_version']}, CUDA {fp['cuda_version']}, "
              f"{fp['device_name']}, capability {fp['capability']}, "
              f"{fp['device_count']} device(s))")
        bad = os.path.join(tmp, "corrupt.json")
        with open(bad, "w") as f:
            f.write('{"fingerprint": {"schema": 1, "torch_ver')

        def warm_serve(tag, cache, plan=None):
            ge.clear()
            model = MaceGaunt(dataclasses.replace(cfg, autotune_cache=cache), device=device,
                              generator=torch.Generator().manual_seed(0))
            eng = EquivariantServeEngine(model, buckets=buckets)
            spent = dict(ge.chain_timing_s)
            t0 = time.perf_counter()
            if plan is None:
                eng.warmup()
            else:
                with injected(plan):
                    eng.warmup()
            warm_s = time.perf_counter() - t0
            picks = {k: ge.measured_pick(k) for k in keys}
            reqs = make_requests(sizes, cfg.n_species, seed=1200)
            eng.run(reqs)
            check(all(r.done and not r.rejected for r in reqs),
                  f"[autotune] {tag}: a request did not complete")
            worst_e, worst_f = served_vs_direct(model, reqs, device)
            failed = eng.metrics.counters["autotune_cache_load_failed"]
            print(f"[autotune] {tag}: warmup {warm_s:.2f} s ({_timing_share(ge, spent)}), "
                  f"{ge.timing_runs} timing runs, autotune_cache_load_failed {failed}; picks "
                  + ", ".join(f"{k[3]} rows gate={k[5]} {v}" for k, v in picks.items())
                  + f"; served {len(reqs)} requests vs direct: energy rel {worst_e:.3e} "
                  f"(tol {F32_IDENTITY_TOL}), forces rel {worst_f:.3e} (tol {F32_LOOSE_TOL})")
            check(worst_e <= F32_IDENTITY_TOL and worst_f <= F32_LOOSE_TOL,
                  f"[autotune] {tag}: served results differ from direct evaluation")
            return picks, failed

        picks, failed = warm_serve("warm cache", path)
        check(ge.timing_runs == 0, f"a warm cache still made {ge.timing_runs} timing runs")
        check(picks == first, "a bucket's pick from the cache differs from the measured one")
        check(failed == 0, "a usable cache counted a load failure")
        for tag, cache, plan in (
                ("corrupt cache file", bad, None),
                ("injected autotune_cache_load fault", path,
                 FaultPlan(seed=0, at={"autotune_cache_load": (0,)}))):
            _, failed = warm_serve(tag, cache, plan)
            check(ge.timing_runs > 0, f"[autotune] {tag}: warmup did not measure cold")
            check(failed == 1, f"[autotune] {tag}: the degradation was not counted")
        ge.set_autotune_cache(None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


TRAIN_MOLECULES, TRAIN_ATOMS = 8, 16   # chain rows 8 x 16 x 64 = 8,192 a layer
TRAIN_STEPS, TRAIN_STOP, TRAIN_LR, TRAIN_WARMUP = 24, 12, 2e-3, 3


def _grad_err(got, want) -> float:
    """Worst per-parameter gradient error, each relative to its reference's
    largest element (floored at 1e-6 of the largest gradient overall)."""
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6 * top, 1e-30)
               for g, w in zip(got, want))


def phase_train(device, cfg):
    """Force-field training on the card: `train_loop` (AdamW + cosine, clip
    10, checkpoints) for TRAIN_STEPS steps on seeded LJ batches of
    TRAIN_MOLECULES clusters of TRAIN_ATOMS atoms, the loss's double backward
    through the chain Function (its forward the kernel when the measured
    pick is `fused_hopper`).  Checks: finite losses that fall, the pick, one
    chain launch a layer and step, a kernel-pinned step against a
    tree-pinned one, resume from a checkpoint against the uninterrupted
    run, E(3) soundness of the trained model, and a few bf16 steps.
    Prints the step time, a profiled step, peak memory and each pinned
    candidate's step time."""
    import os
    import signal
    import tempfile

    import numpy as np
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core import engine as _engine
    from repro_torch.examples.train_force_field import LJBatches
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.train import make_train_step, train_loop

    cuda = device.type == "cuda"
    kernel = "fused_hopper" if cuda else "fused_torch"
    ge = _engine.get_engine()
    rows = TRAIN_MOLECULES * TRAIN_ATOMS * cfg.channels

    def key_for(c):
        return ge.chain_measure_key((c.L,) * c.nu, c.L, c.compute_dtype, rows,
                                    (0,) * c.nu, True, device)

    def measure(c):
        _engine.plan_chain((c.L,) * c.nu, c.L, tune="measure", batch_hint=rows,
                           share_hint=(0,) * c.nu, dtype=c.compute_dtype, gate=True,
                           device=device)
        return ge.measured_pick(key_for(c))

    def new_model(c=cfg):
        return MaceGaunt(c, device=device, generator=torch.Generator().manual_seed(0))

    def new_data():
        return LJBatches(n=TRAIN_MOLECULES, batch=TRAIN_MOLECULES, seed=0, n_atoms=TRAIN_ATOMS)

    def loss_fn(m, b):
        return m.loss(b), {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    key = key_for(cfg)
    pick = measure(cfg)
    fwd = ge.measured_times.get(key, {})
    print(f"[train] {cfg.name} L={cfg.L} L_edge={cfg.L_edge} channels={cfg.channels} "
          f"layers={cfg.n_layers} nu={cfg.nu} grid_gate={cfg.grid_gate}, "
          f"{sum(p.numel() for p in new_model().parameters()):,} parameters; batches of "
          f"{TRAIN_MOLECULES} LJ clusters of {TRAIN_ATOMS} atoms (chain rows {key[3]} a "
          f"layer); measured chain pick {pick} (forward only"
          + "".join(f", {k} {v * 1e3:.4f} ms" for k, v in fwd.items()) + ")")
    check(pick == kernel, f"the measured pick at the training key is {pick!r}, not {kernel}")
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
                       checkpoint_every=8, log_every=1, grad_clip=10.0)
    if cuda:
        print(f"[train] card: {smi_line()}")
    print(f"[train] AdamW + cosine (lr {TRAIN_LR}, warmup {TRAIN_WARMUP}, "
          f"{TRAIN_STEPS} steps, clip 10, weight decay {tcfg.weight_decay}), checkpoints "
          f"every {tcfg.checkpoint_every} steps")
    with tempfile.TemporaryDirectory() as tmp:
        # the uninterrupted run
        marks = []

        def log(m):
            marks.append(time.perf_counter())
            print(f"[train] step {m['step']:3d} loss {m['loss']:.6f} "
                  f"grad_norm {m['grad_norm']:.5f}")

        model = new_model()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        reset_kernel_stats()
        t0 = time.perf_counter()
        state, hist = train_loop(loss_fn, model, new_data(), tcfg,
                                 ckpt_dir=os.path.join(tmp, "run"), hooks={"log": log})
        sync()
        wall = time.perf_counter() - t0
        launches = kernel_stats()["gaunt_chain"]
        peak = torch.cuda.max_memory_allocated() if cuda else None
        losses = [h["loss"] for h in hist]
        check(len(hist) == TRAIN_STEPS and all(np.isfinite(h["loss"]) and
                                               np.isfinite(h["grad_norm"]) for h in hist),
              "a training loss or gradient norm is not finite")
        check(losses[-1] < losses[0] and np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"the loss did not fall: {losses}")
        step_ms = np.diff([t0] + marks) * 1e3
        med = float(np.median(step_ms[3:]))
        print(f"[train] {TRAIN_STEPS} steps in {wall:.2f} s: loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}; step time {med:.2f} ms (host clock, median of steps "
              f"4-{TRAIN_STEPS}; each step ends in the logged loss's host read), first "
              f"step {step_ms[0]:.1f} ms; gaunt_chain launches {launches} "
              f"(expected {cfg.n_layers} x {TRAIN_STEPS}); peak memory "
              + (f"{peak / 2**20:.1f} MiB (max_memory_allocated), {held / 2**20:.1f} MiB of "
                 f"it held before the run, the run's own {(peak - held) / 2**20:.1f} MiB"
                 if cuda else "not measured"))
        if cuda:
            check(launches == cfg.n_layers * TRAIN_STEPS,
                  f"gaunt_chain launched {launches} times in {TRAIN_STEPS} steps, not "
                  f"{cfg.n_layers} a step")

        # stop at TRAIN_STOP (preempted: a blocking checkpoint), resume to the end
        def preempt(m):
            if m["step"] == TRAIN_STOP:
                os.kill(os.getpid(), signal.SIGTERM)

        ck = os.path.join(tmp, "resume")
        stopped, _ = train_loop(loss_fn, new_model(), new_data(), tcfg, ckpt_dir=ck,
                                hooks={"log": preempt})
        check(stopped.step == TRAIN_STOP, f"the preempted run stopped at {stopped.step}")
        it = new_data()
        resumed, hist2 = train_loop(loss_fn, new_model(), it, tcfg, ckpt_dir=ck)
        worst = max(rel_err(a.detach(), b.detach())[1]
                    for a, b in zip(resumed.model.parameters(), state.model.parameters()))
        print(f"[train] stopped at step {TRAIN_STOP} (SIGTERM: blocking checkpoint), "
              f"resumed to {resumed.step}: parameters vs the uninterrupted run rel "
              f"{worst:.3e} (tol {F32_IDENTITY_TOL}); data iterator at step {it.step}, "
              f"first resumed step {hist2[0]['step']}")
        check(resumed.step == TRAIN_STEPS and hist2[0]["step"] == TRAIN_STOP + 1
              and it.step == TRAIN_STEPS, "the data iterator replayed instead of resuming")
        check(worst <= F32_IDENTITY_TOL, "the resumed run differs from the uninterrupted one")

    # E(3): the trained model's energy is invariant, its forces equivariant
    d = new_data().data
    sp = torch.as_tensor(d["species"][0], device=device)
    pos = d["pos"][0]
    Q = random_rotation(11)
    e0, f0 = state.model.energy_forces(sp, torch.as_tensor(pos, device=device))
    e1, f1 = state.model.energy_forces(sp, torch.as_tensor((pos @ Q.T).astype(np.float32),
                                                           device=device))
    f0, f1 = f0.cpu().numpy(), f1.cpu().numpy()
    de = abs(float(e1) - float(e0)) / max(1.0, abs(float(e0)))
    df = float(np.abs(f1 - f0 @ Q.T).max()) / max(1e-30, float(np.abs(f0).max()))
    print(f"[train] trained model under rotation: energy rel {de:.3e}, forces rel {df:.3e} "
          f"(tol {F32_TRANSFORM_TOL})")
    check(de <= F32_TRANSFORM_TOL and df <= F32_TRANSFORM_TOL,
          "the trained model is not rotation invariant/equivariant")

    # the two chain candidates from the same parameters and batch
    batch = {k: torch.as_tensor(v, device=device) for k, v in new_data().next_batch().items()}
    model = new_model()
    params = list(model.parameters())
    out = {}
    for backend in ("tree", kernel):
        with ge.pinned_chain(key, backend):
            loss = model.loss(batch)
            grads = torch.autograd.grad(loss, params)
            out[backend] = (float(loss.detach()), grads)
    (lt, gt), (lk, gk) = out["tree"], out[kernel]
    dl = abs(lk - lt) / max(1.0, abs(lt))
    dg = _grad_err(gk, gt)
    print(f"[train] one step's loss and gradients, kernel vs tree pinned: loss rel {dl:.3e} "
          f"(tol {F32_IDENTITY_TOL}), worst parameter gradient rel {dg:.3e} "
          f"(tol {F32_LOOSE_TOL}, scale-relative)")
    check(dl <= F32_IDENTITY_TOL and dg <= F32_LOOSE_TOL,
          "the kernel-pinned step differs from the tree-pinned step")

    # the training step with each candidate pinned, in turns
    step_fn, opt = make_train_step(loss_fn, tcfg)
    opt_state = opt.init(dict(model.named_parameters()))
    times = {"tree": [], kernel: []}
    for r in range(8):
        for backend in (("tree", kernel) if r % 2 == 0 else (kernel, "tree")):
            with ge.pinned_chain(key, backend):
                t1 = time.perf_counter()
                opt_state, m = step_fn(model, opt_state, batch)
                float(m["loss"])
                times[backend].append((time.perf_counter() - t1) * 1e3)
    tms = {k: float(np.median(v[1:])) for k, v in times.items()}
    faster = min(tms, key=tms.get)
    print(f"[train] training step with each chain candidate pinned (host clock, median of "
          f"7 after one warm step, in turns): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in tms.items())
          + f"; forward-only pick {pick}, faster training step {faster}: "
          + ("same" if faster == pick else "DIFFERENT"))
    if cuda:
        profile_step("train step f32", lambda: None,
                     lambda: (step_fn(model, opt_state, batch), torch.cuda.synchronize()))

    # a few steps with the chain stored at bf16
    cfg_bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    pick_bf = measure(cfg_bf)
    check(pick_bf == kernel, f"the bf16 pick at the training key is {pick_bf!r}")
    reset_kernel_stats()
    _, hist_bf = train_loop(loss_fn, new_model(cfg_bf), new_data(),
                            dataclasses.replace(tcfg, total_steps=3))
    sync()
    launches_bf = kernel_stats()["gaunt_chain_bf16"]
    losses_bf = [h["loss"] for h in hist_bf]
    dbf = abs(losses_bf[0] - losses[0]) / max(1.0, abs(losses[0]))
    print(f"[train] bf16 chain: 3 steps, losses " + " ".join(f"{v:.5f}" for v in losses_bf)
          + f"; first loss vs f32 rel {dbf:.3e} (tol {BF16_LOOSE_TOL}); gaunt_chain_bf16 "
          f"launches {launches_bf}")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist_bf),
          "a bf16 training loss is not finite")
    check(dbf <= BF16_LOOSE_TOL, "the bf16 first-step loss differs from the f32 one")
    if cuda:
        check(launches_bf == cfg.n_layers * 3, f"gaunt_chain_bf16 launched {launches_bf} "
                                               f"times in 3 steps")
    del state, resumed, stopped, model, opt_state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return launches, med, peak, tms


# --------------------------------------------------------------------------
# phase 4c: the paper's two other equivariant models, batched plans, and the
# measured policies
# --------------------------------------------------------------------------

SEGNN_SYSTEMS, SEGNN_HORIZON = 100, 300   # the EGNN/SEGNN N-body batch: 5 particles each
SEGNN_STEPS, SEGNN_LR = 40, 5e-3          # as benchmarks/bench_sanity_nbody.py trains
SEGNN_EQUIVARIANCE_TOL = 2e-3             # tests/test_equivariant_models.py's atol
SELFMIX_NODES = 2560                      # x 32 channels = 81,920 rows (OC20 width)
SELFMIX_EQUIVARIANCE_TOL = 3e-3           # tests/test_equivariant_models.py's atol
BATCH_VS_PLAN_TOL = 1e-6                  # plan_batch buckets vs per-plan calls


def _sgd_steps(model, batch, steps: int, lr: float, device, tag: str):
    """``steps`` plain SGD steps on one batch -> (losses, step ms on the
    host clock, each step ending in its loss's host read)."""
    import numpy as np
    import torch

    params = list(model.parameters())
    losses, ms = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= lr * g
        losses.append(float(loss.detach()))
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[segnn] {tag} step {s + 1:3d} loss {losses[-1]:.6f}")
    check(all(np.isfinite(losses)), f"[segnn] {tag}: a loss is not finite")
    check(losses[-1] < losses[0], f"[segnn] {tag}: the loss did not fall: {losses}")
    return losses, ms


def phase_segnn(device, n_systems: int = SEGNN_SYSTEMS, steps: int = SEGNN_STEPS,
                cfg=None):
    """`gaunt_segnn_nbody` at full width (L=1, L_edge=1, 32 channels, 4
    layers; chain_tune='measure') on ``n_systems`` charged N-body systems
    of 5 particles in one pass (n_systems x 5 x 5 x 32 chain rows a layer):
    the measured resident chain key (entries ('sh', 'fourier')), the
    forward finite and rotation-equivariant, the kernel-pinned forward and
    loss gradients against the tree-pinned ones, one `gaunt_chain` launch a
    layer, the quadrature gate against the SH gate, ``steps`` SGD steps on
    the kernel (every loss printed, finite, falling) and the same steps with
    the CG parameterization (Fig. 1(e)), step times, peak memory and a
    profiled step.  -> gaunt_chain launches in the training run."""
    import numpy as np
    import torch
    from repro_torch.configs.gaunt_ff import gaunt_segnn_nbody
    from repro_torch.core import engine as _engine
    from repro_torch.data import nbody_dataset
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.models.equivariant import SegnnNBody

    cuda = device.type == "cuda"
    kernel = "fused_hopper"
    cfg = cfg or dataclasses.replace(gaunt_segnn_nbody, chain_tune="measure")
    ge = _engine.get_engine()
    t0 = time.perf_counter()
    data = nbody_dataset(n_systems, horizon=SEGNN_HORIZON, seed=0)
    batch = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    S, n = data["pos"].shape[:2]
    rows = S * n * n * cfg.channels
    print(f"[segnn] {cfg.name}: L={cfg.L} L_edge={cfg.L_edge} channels={cfg.channels} "
          f"layers={cfg.n_layers}; nbody_dataset({S}, horizon={SEGNN_HORIZON}, seed=0) "
          f"made in {time.perf_counter() - t0:.2f} s: {S} systems x {n} particles, "
          f"{rows} chain rows a layer; card {smi_line() if cuda else 'cpu'}")

    def new_model(c=cfg):
        return SegnnNBody(c, device=device, generator=torch.Generator().manual_seed(0))

    def fwd(m, pos=None, vel=None):
        return m(batch["charge"], batch["pos"] if pos is None else pos,
                 batch["vel"] if vel is None else vel)

    model = new_model()
    with torch.no_grad():
        out = fwd(model)
    _sync(device)
    key = ge.chain_measure_key((cfg.L, cfg.L_edge), cfg.L, "float32", rows, None, False,
                               device, ("sh", "fourier"), "sh")
    times, spread = ge.measured_times[key], ge.measured_spread[key]
    pick = ge.measured_pick(key)
    print(f"[segnn] measured resident chain key Ls=(1, 1) entries=('sh', 'fourier') rows="
          f"{key[3]} ({'CUDA events' if cuda else 'host clock'} per eager call, median of "
          f"{_engine._MEASURE_REPS}, [min, max]): "
          + ", ".join(f"{k} {v * 1e3:.4f} ms [{spread[k][0] * 1e3:.4f}, {spread[k][1] * 1e3:.4f}]"
                      for k, v in times.items()) + f" -> {pick}")
    check(set(times) == {"tree", "looped", kernel if cuda else "fused_torch"},
          f"[segnn] the measured candidates are {sorted(times)}")
    check(out.shape == (S, n, 3) and bool(torch.isfinite(out).all()),
          "[segnn] the forward is not finite or misshapen")

    # rotation equivariance of the measured forward
    Q = torch.as_tensor(random_rotation(21), dtype=torch.float32, device=device)
    with torch.no_grad():
        out_r = fwd(model, batch["pos"] @ Q.T, batch["vel"] @ Q.T)
    diff = (out_r - out @ Q.T).abs()
    excess = float((diff - SEGNN_EQUIVARIANCE_TOL - 1e-3 * (out @ Q.T).abs()).max())
    print(f"[segnn] forward under rotation: max abs err {float(diff.max()):.3e} "
          f"(tol {SEGNN_EQUIVARIANCE_TOL} + 1e-3 |x|, the reference test's)")
    check(excess <= 0, "[segnn] the forward is not rotation-equivariant")

    # kernel-pinned against tree-pinned: forward, loss and gradients
    params = list(model.parameters())
    res = {}
    for backend in ("tree", kernel):
        with ge.pinned_chain(key, backend):
            with torch.no_grad():
                reset_kernel_stats()
                o = fwd(model)
                _sync(device)
                launched = kernel_stats()["gaunt_chain"]
            loss = model.loss(batch)
            grads = torch.autograd.grad(loss, params)
        res[backend] = (o, float(loss.detach()), grads, launched)
    (o_t, l_t, g_t, _), (o_k, l_k, g_k, n_k) = res["tree"], res[kernel]
    ferr, frel = rel_err(o_k, o_t)
    dl = abs(l_k - l_t) / max(1.0, abs(l_t))
    dg = _grad_err(g_k, g_t)
    print(f"[segnn] kernel vs tree pinned: forward max abs err {ferr:.3e} rel {frel:.3e} "
          f"(tol {F32_IDENTITY_TOL}); loss rel {dl:.3e} (tol {F32_IDENTITY_TOL}); worst "
          f"parameter gradient rel {dg:.3e} (tol {F32_LOOSE_TOL}, scale-relative); "
          f"gaunt_chain launches per pinned forward {n_k} (expected {cfg.n_layers})")
    check(frel <= F32_IDENTITY_TOL and dl <= F32_IDENTITY_TOL and dg <= F32_LOOSE_TOL,
          "[segnn] the kernel-pinned model differs from the tree-pinned one")
    if cuda:
        check(n_k == cfg.n_layers, f"[segnn] gaunt_chain launched {n_k} times a forward")

    # the quadrature gate against the SH gate, same parameters
    on = new_model(dataclasses.replace(cfg, grid_gate="on"))
    on.load_state_dict(model.state_dict())
    with torch.no_grad():
        gerr, grel = rel_err(fwd(on), out)
    print(f"[segnn] grid_gate='on' (the gate on the S^2 quadrature grid) vs 'off': max abs "
          f"err {gerr:.3e} rel {grel:.3e} (tol {F32_IDENTITY_TOL})")
    check(grel <= F32_IDENTITY_TOL, "[segnn] the quadrature gate differs from the SH gate")
    del on, res, g_t, g_k

    # Fig. 1(e): SGD on the kernel, then with CG parameters, from one init
    init = {k: v.clone() for k, v in model.state_dict().items()}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    with ge.pinned_chain(key, kernel):
        reset_kernel_stats()
        losses_g, ms_g = _sgd_steps(model, batch, steps, SEGNN_LR, device, "gaunt")
        _sync(device)
        launches = kernel_stats()["gaunt_chain"]
    peak = torch.cuda.max_memory_allocated() if cuda else None
    cg = new_model(dataclasses.replace(cfg, tp_impl="cg"))
    cg.load_state_dict(init)
    losses_c, ms_c = _sgd_steps(cg, batch, steps, SEGNN_LR, device, "cg")
    med_g, med_c = float(np.median(ms_g[3:])), float(np.median(ms_c[3:]))
    print(f"[segnn] {steps} SGD steps (lr {SEGNN_LR}) on the kernel: loss {losses_g[0]:.6f} "
          f"-> {losses_g[-1]:.6f}, step {med_g:.2f} ms; with CG: loss {losses_c[0]:.6f} -> "
          f"{losses_c[-1]:.6f}, step {med_c:.2f} ms (host clock, median of steps 4-{steps}, "
          f"each ending in its loss's host read); final loss gaunt/cg "
          f"{losses_g[-1] / max(losses_c[-1], 1e-30):.3f}; gaunt_chain launches {launches} "
          f"(expected {cfg.n_layers} x {steps}); peak memory "
          + (f"{peak / 2**20:.1f} MiB (max_memory_allocated; {held / 2**20:.1f} MiB held "
             f"before)" if cuda else "not measured"))
    if cuda:
        check(launches == cfg.n_layers * steps,
              f"[segnn] gaunt_chain launched {launches} times in {steps} steps")

        def step():
            loss = model.loss(batch)
            torch.autograd.grad(loss, params)
            torch.cuda.synchronize()

        with ge.pinned_chain(key, kernel):
            profile_step("segnn train step (kernel pinned)", lambda: None, step)
    del model, cg, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return launches


def phase_selfmix(device, nodes: int = SELFMIX_NODES, L: int | None = None,
                  C: int | None = None):
    """`SelfmixLayer` at ``L`` and ``C`` channels (default
    `gaunt_equiformer_selfmix`'s width, L=4, 32 channels) on ``nodes``
    nodes, tune='measure': the measured shared-operand key (share (0, 0)),
    the product branch (output - x) of the tree-, looped- and kernel-pinned
    layers and of the gaunt_fused route against each other, equivariance,
    one `gaunt_chain` launch a pinned call, each route's time (CUDA events
    and host clock, the CG route beside), and compute_dtype bf16 against
    f32 with the pick that 'auto' resolves to.  -> gaunt_chain launches in
    the kernel-pinned call."""
    import numpy as np
    import torch
    from repro_torch.configs.gaunt_ff import gaunt_equiformer_selfmix as cfg
    from repro_torch.core import engine as _engine
    from repro_torch.core.so3 import wigner_D_real_packed
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.models.equivariant import SelfmixLayer

    cuda = device.type == "cuda"
    L, C = L or cfg.L, C or cfg.channels
    ge = _engine.get_engine()
    rng = np.random.default_rng(31)
    x = torch.as_tensor(rng.normal(size=(nodes, C, (L + 1) ** 2)), dtype=torch.float32,
                        device=device)

    def layer(**kw):
        m = SelfmixLayer(L, C, device=device, generator=torch.Generator().manual_seed(0), **kw)
        with torch.no_grad():  # non-unit per-degree weights: the shared-operand path
            for w in (m.w1, m.w2, m.w3):
                w.copy_(torch.linspace(0.6, 1.4, w.numel(), device=device))
        return m

    base = layer(tune="measure")
    with torch.no_grad():
        base(x)
    _sync(device)
    rows = nodes * C
    key = ge.chain_measure_key((L, L), L, "float32", rows, (0, 0), False, device)
    times, spread = ge.measured_times[key], ge.measured_spread[key]
    pick = ge.measured_pick(key)
    width = cfg.name if (L, C) == (cfg.L, cfg.channels) else "EquiformerV2's Selfmix"
    print(f"[selfmix] {width}: L={L} channels={C}, {nodes} nodes ({rows} rows); "
          f"measured key Ls=({L}, {L}) share (0, 0) rows={key[3]} "
          f"({'CUDA events' if cuda else 'host clock'} per eager call, median of "
          f"{_engine._MEASURE_REPS}, [min, max]): "
          + ", ".join(f"{k} {v * 1e3:.4f} ms [{spread[k][0] * 1e3:.4f}, {spread[k][1] * 1e3:.4f}]"
                      for k, v in times.items()) + f" -> {pick}")
    routes = {}
    launches = 0
    with torch.no_grad():
        for backend in ("tree", "looped", "fused_hopper"):
            with ge.pinned_chain(key, backend):
                reset_kernel_stats()
                routes[backend] = base(x)
                _sync(device)
                n_k = kernel_stats()["gaunt_chain"]
            if backend == "fused_hopper":
                launches = n_k
        fused = layer(tp_impl="gaunt_fused")
        fused.load_state_dict(base.state_dict())
        routes["gaunt_fused"] = fused(x)
    # the product branch alone: x, which every route adds alike, would hide
    # a fault in the chain
    branch = {k: v - x for k, v in routes.items()}
    worst = max(rel_err(v, branch["tree"])[1] for v in branch.values())
    print(f"[selfmix] product branch (output - x) against the tree's (max |tree| "
          f"{float(branch['tree'].abs().max()):.3e}): "
          + ", ".join(f"{k} rel {rel_err(v, branch['tree'])[1]:.3e}" for k, v in branch.items())
          + f" (tol {F32_IDENTITY_TOL}); gaunt_chain launches per kernel-pinned call "
          f"{launches} (expected 1)")
    check(worst <= F32_IDENTITY_TOL, "[selfmix] the routes disagree")
    if cuda:
        check(launches == 1, f"[selfmix] gaunt_chain launched {launches} times in one call")
    D = torch.as_tensor(wigner_D_real_packed(L, 0.5, 1.1, -0.8), dtype=torch.float32,
                        device=device)
    with torch.no_grad():
        y1 = base(x)
        y2 = base(torch.einsum("ij,ncj->nci", D, x))
        want = torch.einsum("ij,ncj->nci", D, y1)
    excess = float(((y2 - want).abs() - SELFMIX_EQUIVARIANCE_TOL - 1e-3 * want.abs()).max())
    print(f"[selfmix] under rotation: max abs err {float((y2 - want).abs().max()):.3e} "
          f"(tol {SELFMIX_EQUIVARIANCE_TOL} + 1e-3 |x|, the reference test's)")
    check(excess <= 0, "[selfmix] the layer is not rotation-equivariant")
    if cuda:
        cg = layer(tp_impl="cg")
        cg.load_state_dict(base.state_dict())
        calls = {}
        for backend in ("tree", "looped", "fused_hopper"):
            calls[f"chain {backend}"] = (backend, base)
        calls["gaunt_fused"] = (None, fused)
        calls["cg (another parameterization)"] = (None, cg)
        parts = []
        with torch.no_grad():
            for name, (backend, m) in calls.items():
                if backend is None:
                    ev = event_ms(lambda: m(x))
                    hm, _ = host_ms(lambda: m(x), device, 21)
                else:
                    with ge.pinned_chain(key, backend):
                        ev = event_ms(lambda: m(x))
                        hm, _ = host_ms(lambda: m(x), device, 21)
                parts.append(f"{name} {ev:.4f} ms events / {hm:.4f} ms host")
        print(f"[times] selfmix layer ({nodes} x {C} x {(L + 1) ** 2}, {smi_line()}): "
              + ", ".join(parts) + " (CUDA events median of 50; host clock median of 21, "
              "each call synchronised)")
    # bf16 storage, and what 'auto' resolves to
    bf = layer(tune="measure", compute_dtype="bfloat16")
    bf.load_state_dict(base.state_dict())
    auto = layer(tune="measure", compute_dtype="auto")
    auto.load_state_dict(base.state_dict())
    with torch.no_grad():
        ebf, rbf = rel_err(bf(x).float(), y1)
        auto(x)
        again = layer(tune="measure", compute_dtype="auto")
        again.load_state_dict(auto.state_dict())
        runs = ge.timing_runs
        kept = again.storage_dtype(x[: nodes // 2])
    auto_key = ge.chain_measure_key((L, L), L, "auto", rows, (0, 0), False, device)
    bkey = ge.chain_measure_key((L, L), L, "bfloat16", rows, (0, 0), False, device)
    t, sp = ge.measured_times.get(auto_key, {}), ge.measured_spread.get(auto_key, {})
    print(f"[selfmix] compute_dtype='bfloat16' (pick {ge.measured_pick(bkey)}) vs f32: max "
          f"abs err {ebf:.3e} rel {rbf:.3e} (tol {BF16_IDENTITY_TOL}); 'auto' resolves to "
          f"{auto.storage_dtype(x)} ("
          + ", ".join(f"{k} {v * 1e3:.4f} ms, fastest {sp[k][0] * 1e3:.4f}"
                      for k, v in t.items())
          + f"; {'CUDA events' if cuda else 'host clock'}, median of 20; bf16 only below "
          f"the fastest f32); a layer "
          f"loaded from its state keeps {kept} at half the rows with "
          f"{ge.timing_runs - runs} timing runs")
    check(rbf <= BF16_IDENTITY_TOL, "[selfmix] the bf16 layer differs from the f32 one")
    check(kept == auto.storage_dtype(x) and ge.timing_runs == runs,
          "[selfmix] a reloaded layer did not keep the stored dtype")
    del x, routes, branch, base, fused, bf, auto, again
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return launches


EQUIFORMER_BUCKET = (86, 16)               # the benchmark cell's bucket: 86 atoms x 16 slots


def phase_equiformer(device, bucket=EQUIFORMER_BUCKET, sizes=range(70, 87), cfg=None,
                     reps: int = 5):
    """`EquiformerV2Gaunt` at `gaunt_equiformer_v2_oc20`
    served through `EquivariantServeEngine` on one bucket, its step a CUDA
    graph: OC20-sized adsorbate slabs (`perfbench.families.equiformer.slabs`)
    fill every slot; the measured Selfmix pick, the capture, the graph's
    kernel launches per replay, every served system against the plain
    float64 reference (`perfbench.equiformer_reference`) and against a
    direct evaluation, the graph step's time (host clock after a
    synchronisation, median of ``reps``) and peak memory.  -> the replay's
    launches."""
    import dataclasses

    import numpy as np
    import torch
    from perfbench.equiformer_reference import EquiformerReference
    from perfbench.families.equiformer import slabs
    from repro_torch.configs.gaunt_ff import gaunt_equiformer_v2_oc20
    from repro_torch.core import engine as _engine
    from repro_torch.models.equiformer import EquiformerV2Gaunt
    from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine

    cfg = cfg or gaunt_equiformer_v2_oc20
    max_atoms, n_slots = bucket
    model = EquiformerV2Gaunt(cfg, device=device, generator=torch.Generator().manual_seed(35))
    n_par = sum(p.numel() for p in model.parameters())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    eng = EquivariantServeEngine(model, buckets=[bucket], warmup=True)
    pool = eng.pools.pools[0]
    ge = _engine.get_engine()
    key = ge.chain_measure_key((cfg.L, cfg.L), cfg.L, cfg.compute_dtype,
                               n_slots * max_atoms * cfg.channels, (0, 0), False, device)
    print(f"[equiformer] {cfg.name}: {n_par / 1e6:.2f} M parameters, L={cfg.L} "
          f"m_max={cfg.m_max} C={cfg.channels} {cfg.n_layers} blocks; bucket {max_atoms} "
          f"atoms x {n_slots} slots; warmup {time.perf_counter() - t0:.1f} s; Selfmix chain "
          f"pick at {key[3]} rows: {ge.measured_pick(key)} ("
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in ge.measured_times.get(key, {}).items())
          + ")")
    if pool.capture_s is not None:
        print(f"[equiformer] graph captured in {pool.capture_s:.2f} s, graph memory "
              f"{pool.graph_bytes / 2 ** 30:.2f} GiB, kernel launches per replay {pool.launches}")
    rng = np.random.default_rng([35, 3])
    reqs = []
    for i in range(n_slots):
        n = int(list(sizes)[i % len(sizes)])
        sp, pos = slabs(n, 1, rng)
        reqs.append(EquivariantRequest(species=sp[0], pos=pos[0], rid=i))
    for r in reqs:
        check(pool.admit(r), "no free slot")
    before = pool.replays
    eng.step()
    check(all(r.done and not r.rejected for r in reqs), "a request was not served")
    check(pool.replays == before + 1 or device.type != "cuda", "the step was not one replay")
    worst_d = worst_e = worst_f = 0.0
    for r in reqs:
        check(np.isfinite(r.energy) and np.all(np.isfinite(r.forces)), f"request {r.rid}: non-finite")
        e, f = model.energy_forces(torch.as_tensor(r.species, device=device),
                                   torch.as_tensor(r.pos, device=device))
        worst_d = max(worst_d, float(np.abs(r.forces - f.cpu().numpy()).max())
                      / max(1e-30, float(f.abs().max())))
    ref = EquiformerReference(dataclasses.asdict(cfg), model.state_dict(), torch.float64,
                              device)
    t1 = time.perf_counter()
    e_ref, f_ref = [], []
    for r in reqs:
        e, f = ref.energy_forces(torch.as_tensor(r.species)[None], torch.as_tensor(r.pos)[None])
        e_ref.append(float(e[0]))
        f_ref.append(f[0].cpu().numpy())
    t_ref = time.perf_counter() - t1
    e_rms = float(np.sqrt(np.mean(np.square(e_ref))))
    f_rms = float(np.sqrt(np.mean(np.concatenate([f.ravel() for f in f_ref]) ** 2)))
    for r, e, f in zip(reqs, e_ref, f_ref):
        worst_e = max(worst_e, abs(r.energy - e) / e_rms)
        worst_f = max(worst_f, float(np.abs(r.forces - f).max()) / f_rms)
    print(f"[equiformer] served {len(reqs)} systems of {min(sizes)}-{max(sizes)} atoms: vs the "
          f"float64 reference energy {worst_e:.3e} of the RMS {e_rms:.4f}, forces {worst_f:.3e} "
          f"of the RMS {f_rms:.4f} (reference {t_ref:.1f} s); served vs direct forces "
          f"{worst_d:.3e} of max|F|")
    check(worst_e < 1e-4 and worst_f < 1e-3, "served EquiformerV2 off the reference")
    if device.type == "cuda":
        times = []
        for _ in range(reps):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            pool.step_staged()
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t)
        print(f"[times] equiformer graph step ({n_slots} x {max_atoms} atoms): "
              f"{1e3 * float(np.median(times)):.2f} ms host clock, median of {reps}; peak "
              f"memory {torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
    launches = dict(pool.launches)
    del eng, pool, model, ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def phase_batched(device, rows: int = 20480):
    """`plan_batch` with two degree signatures in three items, pinned to
    `fused_hopper` (requires_grad=False), against `pair_plain` on the same
    rows (the kernel's own check, at every bucket's shape) and against
    per-plan calls (the bucketing's check): one `gaunt_pair` launch per
    bucket; then a bucket of Fourier-boundary operands (resident filters)
    on a spectral backend against per-plan calls.  -> gaunt_pair launches
    in the batched call."""
    import numpy as np
    import torch
    from repro_torch.core import constants as _c
    from repro_torch.core import engine as _engine
    from repro_torch.core.rep import Rep
    from repro_torch.kernels.gaunt_fused import kernel_stats, pair_plain, reset_kernel_stats

    cuda = device.type == "cuda"
    rng = np.random.default_rng(41)

    def r(L, n):
        return torch.as_tensor(rng.normal(size=(n, (L + 1) ** 2)), dtype=torch.float32,
                               device=device)

    items = [(6, 6, 6, rows), (4, 4, 4, rows // 2), (6, 6, 6, rows // 4)]
    ins = [(r(L1, n), r(L2, n)) for L1, L2, _, n in items]
    bp = _engine.plan_batch(items, backend="fused_hopper", requires_grad=False, device=device)
    with torch.no_grad():
        reset_kernel_stats()
        outs = bp.apply(ins)
        _sync(device)
        launches = kernel_stats()["gaunt_pair"]
        worst, plain = 0.0, 0.0
        for (L1, L2, Lout, n), (x1, x2), got in zip(items, ins, outs):
            p = _engine.plan(L1, L2, Lout, backend="fused_hopper", requires_grad=False,
                             device=device)
            worst = max(worst, rel_err(got, p.apply(x1, x2))[0])
            mats = [_c.to_torch(m, device) for m in _c.pair_matrices(L1, L2, Lout)]
            plain = max(plain, rel_err(got, pair_plain(x1, x2, *mats))[1])
    print(f"[batched] plan_batch {[it[:3] for it in items]} at {[it[3] for it in items]} rows "
          f"on fused_hopper: {len(bp.buckets)} buckets, gaunt_pair launches {launches} "
          f"(expected {len(bp.buckets)}); vs pair_plain rel {plain:.3e} (tol "
          f"{PAIR_VS_PLAIN_TOL}); vs per-plan calls max abs err {worst:.3e} "
          f"(tol {BATCH_VS_PLAN_TOL})")
    check(plain <= PAIR_VS_PLAIN_TOL, "[batched] a bucket differs from pair_plain")
    check(worst <= BATCH_VS_PLAN_TOL, "[batched] a bucket differs from its per-plan call")
    if cuda:
        check(launches == len(bp.buckets), f"[batched] gaunt_pair launched {launches} times")
    # resident filters (a 'fourier' second operand) in one bucket
    L = 4
    item = _engine.BatchItem(L1=L, L2=L, Lout=L,
                             options=(("boundary", ("sh", "fourier", "sh")),))
    n = rows // 4
    xs = [r(L, n), r(L, n // 2)]
    fs = [Rep.from_sh(r(L, n), L).to_fourier("dense"),
          Rep.from_sh(r(L, n // 2), L).to_fourier("dense")]
    for backend in ("fft", "rfft"):
        bpr = _engine.plan_batch([item, item], backend=backend, requires_grad=False,
                                 device=device)
        p = _engine.plan(L, L, L, backend=backend, options={"boundary": ("sh", "fourier", "sh")},
                         requires_grad=False, device=device)
        with torch.no_grad():
            got = bpr.apply(list(zip(xs, fs)))
            rel = max(rel_err(g, p.apply(a, f))[1] for g, a, f in zip(got, xs, fs))
        print(f"[batched] Fourier-boundary bucket ({L}, {L}, {L}) on {backend}, items of {n} "
              f"and {n // 2} rows with resident filters: vs per-plan calls rel {rel:.3e} "
              f"(tol {F32_IDENTITY_TOL})")
        check(rel <= F32_IDENTITY_TOL, f"[batched] the {backend} boundary bucket differs")
    return launches


def phase_policies(device, buckets, sizes):
    """The measured gate policy (`select_gate`) for the force field's chain
    at each serve bucket's rows; `gaunt_mace_ff` with grid_gate='auto'
    served through the bucketed engine, served == direct; then the autotune
    file of this run's measurements (the new key types included) reloaded by
    a fresh engine with zero timing runs."""
    import os
    import tempfile

    import torch
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.core import engine as _engine
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantServeEngine

    ge = _engine.get_engine()
    cfg = dataclasses.replace(gaunt_mace_ff, chain_tune="measure", grid_gate="auto")
    Ls, share = (cfg.L,) * cfg.nu, (0,) * cfg.nu
    bucket_rows = [s.n_slots * s.max_atoms * cfg.channels for s in buckets]
    for rows in bucket_rows:
        pick = ge.select_gate(Ls, cfg.L, batch_hint=rows, share_hint=share, device=device)
        key = ge.chain_measure_key(Ls, cfg.L, "float32", rows, share, False, device) + \
            (("gate", "policy"),)
        t, sp = ge.measured_times.get(key, {}), ge.measured_spread.get(key, {})
        print(f"[policies] select_gate Ls={Ls} rows={rows}: "
              + ", ".join(f"{k} {v * 1e3:.4f} ms (fastest {sp[k][0] * 1e3:.4f})"
                          for k, v in t.items())
              + f" ({'CUDA events' if device.type == 'cuda' else 'host clock'}, median of "
              f"20, each chain on its measured pick, the sh side with its gate epilogue; "
              f"'grid' only below the fastest 'sh') -> {pick}")
    model = MaceGaunt(cfg, device=device, generator=torch.Generator().manual_seed(0))
    eng = EquivariantServeEngine(model, buckets=buckets)
    eng.warmup()
    print(f"[policies] the served model's grid gate, resolved once at warmup (the "
          f"largest bucket's rows, {max(bucket_rows)}): "
          f"{'on' if model.grid_gate_on(max(bucket_rows), device) else 'off'}")
    reqs = make_requests(sizes, cfg.n_species, seed=1400)
    eng.run(reqs)
    check(all(r.done and not r.rejected for r in reqs), "[policies] a request did not complete")
    worst_e, worst_f = served_vs_direct(model, reqs, device)
    print(f"[policies] gaunt_mace_ff grid_gate='auto' served ({len(reqs)} requests, "
          f"{len(buckets)} buckets) vs direct: energy rel {worst_e:.3e} (tol "
          f"{F32_IDENTITY_TOL}), forces rel {worst_f:.3e} (tol {F32_LOOSE_TOL})")
    check(worst_e <= F32_IDENTITY_TOL and worst_f <= F32_LOOSE_TOL,
          "[policies] served results differ from direct evaluation")
    # the resolved gate is part of the model's state: a reload keeps it
    # without timing, at any rows
    gate = model.grid_gate_on(max(bucket_rows), device)
    again = MaceGaunt(cfg, device=device)
    again.load_state_dict(model.state_dict())
    runs = ge.timing_runs
    kept = again.grid_gate_on(min(bucket_rows) // 2, device)
    print(f"[policies] a model loaded from the served model's state: grid gate "
          f"{'on' if kept else 'off'} (stored {'on' if gate else 'off'}), "
          f"{ge.timing_runs - runs} timing runs")
    check(kept == gate and ge.timing_runs == runs,
          "[policies] a reloaded model did not keep the stored grid gate")
    del eng, model, again
    # the slice's other key types: hits after [segnn] and [selfmix], measured
    # here when this phase runs alone
    _engine.plan_chain((1, 1), 1, tune="measure", batch_hint=SEGNN_SYSTEMS * 25 * 32,
                       entry_hint=("sh", "fourier"), device=device)
    _engine.plan_chain((4, 4), 4, tune="measure", batch_hint=SELFMIX_NODES * 32,
                       share_hint=(0, 0), dtype="auto", device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        ge.set_autotune_cache(path)
        ge.flush_autotune_cache()
        ge.set_autotune_cache(None)
        with open(path) as f:
            sel = json.load(f)["selections"]
        kinds = {"auto": sum(e["key"]["dtype"] == "auto" for e in sel),
                 "gate policy": sum(["gate", "policy"] in e["key"].get("extra", [])
                                    for e in sel),
                 "non-SH bases": sum(any(x[0] == "entries" for x in e["key"].get("extra", []))
                                     for e in sel)}
        check(all(kinds.values()), f"[policies] the cache file lacks a new key type: {kinds}")
        warm = _engine.GauntEngine(cache_path=path)
        n = warm.load_autotune_cache()
        replay = 0
        for k, b in ge._measured.items():
            if isinstance(k, tuple) and k not in ge._pins:
                check(warm.measured_pick(k) == b, f"[policies] key {k} reloaded as "
                                                  f"{warm.measured_pick(k)}, not {b}")
                replay += 1
        for rows in bucket_rows:
            warm.select_gate(Ls, cfg.L, batch_hint=rows, share_hint=share, device=device)
        print(f"[policies] autotune file of this run: {len(sel)} selections ("
              + ", ".join(f"{k} {v}" for k, v in kinds.items())
              + f"); a fresh engine loaded {n}, {replay} chain keys as picked, "
              f"select_gate at every bucket: {warm.timing_runs} timing runs")
        check(warm.timing_runs == 0, "[policies] the reloaded cache still timed")


# --------------------------------------------------------------------------
# phase 4d: the paper's general convolution, the manybody plans, the cost
# model's calibration, the quickstart
# --------------------------------------------------------------------------

GENERAL_TRAIN_STEPS = 6
MANYBODY_ROWS = 8192


def phase_general(device, cfg, buckets, sizes, escn_times=None, train_steps=GENERAL_TRAIN_STEPS):
    """Full-width `gaunt_mace_ff` with conv_impl='general' (the filter Y(r)
    on its Fourier grid once per geometry, a direct 2D convolution a layer)
    served through the bucketed engine, each bucket's step a CUDA graph:
    served == direct, general == eSCN at the same parameters, rotation,
    one chain launch a layer a replay, each bucket's graph and eager step
    against [main]'s eSCN step (``escn_times``), a profiled 32-atom graph
    step, a fresh engine warm from this phase's autotune file; then a few
    `train_loop` steps and a kernel- vs tree-pinned step.  -> the served
    run's launches of 'gaunt_chain', 'direct_conv' and
    'direct_conv_adjoint', counted through the graphs' replays."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.core import engine as _engine
    from repro_torch.examples.train_force_field import LJBatches
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantServeEngine
    from repro_torch.train import train_loop

    cuda = device.type == "cuda"
    kernel = "fused_hopper" if cuda else "fused_torch"
    gcfg = dataclasses.replace(cfg, conv_impl="general")
    ge = _engine.get_engine()
    model = MaceGaunt(gcfg, device=device, generator=torch.Generator().manual_seed(0))
    eng = EquivariantServeEngine(model, buckets=buckets)
    runs = ge.timing_runs
    t0 = time.perf_counter()
    eng.warmup()
    print(f"[general] {gcfg.name} conv_impl='general' L={gcfg.L} L_edge={gcfg.L_edge} "
          f"channels={gcfg.channels} layers={gcfg.n_layers} nu={gcfg.nu}: warmup "
          f"{time.perf_counter() - t0:.2f} s, {ge.timing_runs - runs} timing runs")
    conv = model.conv
    picks = {}
    for pool in eng.pools:
        key = _bucket_key(ge, gcfg, pool, device)
        picks[pool.spec.label()] = ge.measured_pick(key)
        n = pool.spec.max_atoms
        print(f"[general] bucket {pool.spec.label()}: conv backend {conv.backend!r} "
              f"(resident filter: a dense {2 * gcfg.L_edge + 1}x{2 * gcfg.L_edge + 1} grid "
              f"per edge, built once per geometry; {pool.spec.n_slots * n * n * gcfg.channels:,}"
              f" edge-channel rows a layer, each a direct {2 * gcfg.L + 1}x{2 * gcfg.L + 1} "
              f"(*) {2 * gcfg.L_edge + 1}x{2 * gcfg.L_edge + 1} convolution into a "
              f"{2 * (gcfg.L + gcfg.L_edge) + 1}-wide grid); chain pick "
              f"{picks[pool.spec.label()]}"
              + (f"; graph captured in {pool.capture_s * 1e3:.1f} ms, graph memory "
                 f"{pool.graph_bytes / 2**20:.1f} MiB, kernel launches per replay "
                 f"{pool.launches or '{}'}" if cuda else ""))
        if cuda:
            check(pool.compiled() and pool.graph_bytes is not None,
                  f"[general] bucket {pool.spec.label()}: no graph after warmup")
            if picks[pool.spec.label()] == kernel:
                check(pool.launches.get("gaunt_chain") == gcfg.n_layers,
                      f"[general] bucket {pool.spec.label()}: {pool.launches} chain "
                      f"launches per replay, not one a layer")
            # the direct conv: a forward a layer, and in the force backward
            # one adjoint pass a layer for both of its gradients
            check(pool.launches.get("direct_conv") == gcfg.n_layers
                  and pool.launches.get("direct_conv_adjoint") == gcfg.n_layers,
                  f"[general] bucket {pool.spec.label()}: {pool.launches} direct conv "
                  f"launches per replay, not a forward and an adjoint a layer")
    reqs = make_requests(sizes, gcfg.n_species, seed=100)
    replays = [p.replays for p in eng.pools]
    reset_kernel_stats()
    eng.run(reqs)
    if cuda:
        torch.cuda.synchronize()
    stats = kernel_stats()
    launches = stats["gaunt_chain"]
    per_bucket = {p.spec.label(): (p.replays - r0, p.launches.get("gaunt_chain", 0)
                                   * (p.replays - r0)) for p, r0 in zip(eng.pools, replays)}
    print(f"[general] served {len(reqs)} requests: gaunt_chain launches {launches}, "
          f"direct_conv {stats['direct_conv']}, direct_conv_adjoint "
          f"{stats['direct_conv_adjoint']} (counted through graph replays; per bucket "
          f"(replays, chain launches): {per_bucket})")
    check(all(r.done and not r.rejected for r in reqs), "[general] a request did not complete")
    if cuda:
        check(launches == sum(v for _, v in per_bucket.values()) and launches > 0,
              f"[general] gaunt_chain launches {launches} differ from the graphs' "
              f"replays {per_bucket}")
        steps = sum(r for r, _ in per_bucket.values())
        check(stats["direct_conv"] == stats["direct_conv_adjoint"] == steps * gcfg.n_layers,
              f"[general] direct conv launches {stats} differ from a forward and an "
              f"adjoint a layer in each of the {steps} replays")
    worst_e, worst_f = served_vs_direct(model, reqs, device)
    print(f"[general] served vs direct: energy rel {worst_e:.3e} (tol {F32_IDENTITY_TOL}), "
          f"forces rel {worst_f:.3e} (tol {F32_LOOSE_TOL})")
    check(worst_e <= F32_IDENTITY_TOL and worst_f <= F32_LOOSE_TOL,
          "[general] served results differ from direct evaluation")
    # the two convolutions compute one function
    escn = MaceGaunt(cfg, device=device)
    escn.load_state_dict(model.state_dict())
    worst_e = worst_f = 0.0
    for r in reqs[-3:]:
        sp, pos = (torch.as_tensor(a, device=device) for a in (r.species, r.pos))
        e0, f0 = model.energy_forces(sp, pos)
        e1, f1 = escn.energy_forces(sp, pos)
        worst_e = max(worst_e, rel_err(e0, e1)[1])
        worst_f = max(worst_f, float((f0 - f1).abs().max()) / max(1e-30, float(f1.abs().max())))
    print(f"[general] general vs eSCN at the same parameters ({len(reqs[-3:])} molecules): "
          f"energy rel {worst_e:.3e} (tol {F32_IDENTITY_TOL}), forces rel {worst_f:.3e} "
          f"(tol {F32_LOOSE_TOL})")
    check(worst_e <= F32_IDENTITY_TOL and worst_f <= F32_LOOSE_TOL,
          "[general] the general and eSCN models differ")
    del escn
    r0 = reqs[-1]
    Q = random_rotation(7)
    sp = torch.as_tensor(r0.species, device=device)
    e0, f0 = model.energy_forces(sp, torch.as_tensor(r0.pos, device=device))
    e1, f1 = model.energy_forces(sp, torch.as_tensor((r0.pos @ Q.T).astype(np.float32),
                                                     device=device))
    f0, f1 = f0.cpu().numpy(), f1.cpu().numpy()
    de = abs(float(e1) - float(e0)) / max(1.0, abs(float(e0)))
    df = float(np.abs(f1 - f0 @ Q.T).max()) / max(1e-30, float(np.abs(f0).max()))
    print(f"[general] rotation: energy rel {de:.3e} (tol {F32_TRANSFORM_TOL}), forces rel "
          f"{df:.3e} (tol {F32_LOOSE_TOL})")
    check(de <= F32_TRANSFORM_TOL and df <= F32_LOOSE_TOL, "[general] rotation check failed")
    if cuda:
        times = phase_graph_times(eng, "serve general conv")
        for label, (gh, gev, xh, xev) in times.items():
            if escn_times and label in escn_times:
                eh, eev = escn_times[label][:2]
                print(f"[times] bucket {label}: general graph step {gh:.3f} ms host / "
                      f"{gev:.3f} ms events against [main]'s eSCN graph step {eh:.3f} / "
                      f"{eev:.3f} ms: x{gh / eh:.2f} host")
        large = eng.pools.pools[-1]

        def admit():
            for r in make_requests([large.spec.max_atoms] * large.spec.n_slots,
                                   gcfg.n_species, seed=900):
                check(eng.add_request(r), "no free slot for the profiled step")

        profile_step(f"serve step general conv {large.spec.n_slots} x "
                     f"{large.spec.max_atoms} atoms graph", admit, eng.step)
    # a fresh engine warm from this phase's autotune file
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        ge.set_autotune_cache(path)
        ge.flush_autotune_cache()
        ge.clear()
        warm = MaceGaunt(dataclasses.replace(gcfg, autotune_cache=path), device=device,
                         generator=torch.Generator().manual_seed(0))
        weng = EquivariantServeEngine(warm, buckets=buckets)
        weng.warmup()
        wpicks = {p.spec.label(): ge.measured_pick(_bucket_key(ge, gcfg, p, device))
                  for p in weng.pools}
        print(f"[general] a fresh engine from this phase's autotune file: "
              f"{ge.timing_runs} timing runs, picks {wpicks}")
        check(ge.timing_runs == 0 and wpicks == picks,
              "[general] the autotune file did not warm the general engine")
        ge.set_autotune_cache(None)
        del weng, warm
    del eng
    # training through the general conv: the loss's double backward runs
    # through the direct 2D convolution's kernel pair
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=train_steps,
                       log_every=1, grad_clip=10.0)

    def loss_fn(m, b):
        return m.loss(b), {}

    def new_data():
        return LJBatches(n=TRAIN_MOLECULES, batch=TRAIN_MOLECULES, seed=0, n_atoms=TRAIN_ATOMS)

    rows = TRAIN_MOLECULES * TRAIN_ATOMS * gcfg.channels
    _engine.plan_chain((gcfg.L,) * gcfg.nu, gcfg.L, tune="measure", batch_hint=rows,
                       share_hint=(0,) * gcfg.nu, gate=True, device=device)
    key = ge.chain_measure_key((gcfg.L,) * gcfg.nu, gcfg.L, "float32", rows,
                               (0,) * gcfg.nu, True, device)
    marks = []
    t0 = time.perf_counter()
    _, hist = train_loop(loss_fn, MaceGaunt(gcfg, device=device,
                                            generator=torch.Generator().manual_seed(0)),
                         new_data(), tcfg, hooks={"log": lambda m: marks.append(
                             time.perf_counter())})
    losses = [h["loss"] for h in hist]
    step_ms = np.diff([t0] + marks) * 1e3
    print(f"[general] train_loop {train_steps} steps on {TRAIN_MOLECULES} x {TRAIN_ATOMS}-atom "
          f"LJ batches (chain pick {ge.measured_pick(key)}): losses "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; step time {float(np.median(step_ms[1:])):.2f} ms (host clock, median of "
          f"steps 2-{train_steps}), first {step_ms[0]:.1f} ms")
    check(len(hist) == train_steps and all(np.isfinite(h["loss"]) and
                                           np.isfinite(h["grad_norm"]) for h in hist),
          "[general] a training loss or gradient norm is not finite")
    batch = {k: torch.as_tensor(v, device=device) for k, v in new_data().next_batch().items()}
    tm = MaceGaunt(gcfg, device=device, generator=torch.Generator().manual_seed(0))
    params = list(tm.parameters())
    out = {}
    for backend in ("tree", kernel):
        with ge.pinned_chain(key, backend):
            loss = tm.loss(batch)
            out[backend] = (float(loss.detach()), torch.autograd.grad(loss, params))
    (lt, gt), (lk, gk) = out["tree"], out[kernel]
    dl, dg = abs(lk - lt) / max(1.0, abs(lt)), _grad_err(gk, gt)
    print(f"[general] one step's loss and gradients, kernel vs tree pinned: loss rel "
          f"{dl:.3e} (tol {F32_IDENTITY_TOL}), worst parameter gradient rel {dg:.3e} (tol "
          f"{F32_LOOSE_TOL})")
    check(dl <= F32_IDENTITY_TOL and dg <= F32_LOOSE_TOL,
          "[general] the kernel-pinned training step differs from the tree-pinned one")
    del model, tm, out, gk, gt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {k: stats[k] for k in ("gaunt_chain", "direct_conv", "direct_conv_adjoint")}


# the direct conv at the general conv's served shape: 16 slots x 32 x 32
# atom pairs (edges), 256 channels, a 5 x 5 feature grid (L = 2) per channel
# and a 7 x 7 filter grid (L_edge = 3) shared by an edge's channels
DIRECT_LEAD = (16, 32, 32, 256)
DIRECT_SIZES = (5, 7)
# the odd shapes of the tests: (n1, n2), lead of F1, lead of F2
DIRECT_CASES = [((5, 7), (64, 40), (64, 1)), ((7, 5), (64, 40), (64, 1)),
                ((3, 9), (64, 40), (64, 40)), ((9, 9), (8, 1), (8, 33)),
                ((5, 11), (16, 40), (16, 1)), ((4, 6), (3, 5), (3, 5))]


def _direct_grids(lead1, lead2, n1, n2, device, seed, dtype="complex64"):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn(*lead1, n1, n1, dtype=dt, device=device, generator=g),
            torch.randn(*lead2, n2, n2, dtype=dt, device=device, generator=g))


def compare_direct_conv(A, B, second: bool = True):
    """`full_conv` (the kernel pair on CUDA tensors) against the plain
    versions on the same tensors: the forward, both adjoints (one random
    output gradient) and, with ``second``, the double backward against
    autograd through the plain shift-and-add.  -> (forward rel, adjoint
    rel, double backward rel or None, forward max abs error)."""
    import torch
    from repro_torch.kernels.direct_conv import full_conv, full_conv_plain, valid_corr_plain

    def rel(got, want):
        return float((got - want).abs().max()) / max(1e-30, float(want.abs().max()))

    with torch.no_grad():
        want = full_conv_plain(A, B)
        got = full_conv(A, B)
        fwd, err = rel(got, want), float((got - want).abs().max())
        del got
    a, b = A.detach().requires_grad_(True), B.detach().requires_grad_(True)
    gO = torch.randn_like(want)
    del want
    gA, gB = torch.autograd.grad(full_conv(a, b), (a, b), gO)
    with torch.no_grad():
        wA = valid_corr_plain(gO, B.conj())
        wB = valid_corr_plain(gO, A.conj())
        wA = wA.sum_to_size(A.shape)
        wB = wB.sum_to_size(B.shape)
    adj = max(rel(gA, wA), rel(gB, wB))
    del gA, gB, wA, wB, gO
    dbl = None
    if second:
        outs = []
        for fn in (full_conv, full_conv_plain):
            a, b = A.detach().requires_grad_(True), B.detach().requires_grad_(True)
            O = fn(a, b)
            ga, gb = torch.autograd.grad((O.abs() ** 2).sum(), (a, b), create_graph=True)
            s = (ga.abs() ** 2).sum() + (gb.abs() ** 2).sum()
            outs.append(torch.autograd.grad(s, (a, b)))
        dbl = max(rel(outs[0][0], outs[1][0]), rel(outs[0][1], outs[1][1]))
    return fwd, adj, dbl, err


def phase_direct_conv(device, lead=DIRECT_LEAD, cases=DIRECT_CASES):
    """The direct 2D convolution's kernel pair (`kernels/direct_conv.py`)
    against its plain versions on the card: the odd shapes (the generic
    kernels at (5, 11), (4, 6) and complex128), then the served shape
    ``lead`` (F1 [*lead, 5, 5], F2 [*lead[:-1], 1, 7, 7]): forward, both
    adjoints, the double backward on one edge-slot; a check that one
    forward and backward launch one kernel each; then device times against
    the bound, the plain shift-and-add and the fft route of `conv2d_full`.
    -> the kernels line's entry, without its launches (those of the main
    path: `phase_general`'s served run)."""
    import torch
    from repro_torch.core.gaunt import conv2d_full
    from repro_torch.kernels.direct_conv import (full_conv, full_conv_plain, launch_adjoint,
                                                 launch_full_conv)
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats

    cuda = device.type == "cuda"
    for i, ((n1, n2), l1, l2) in enumerate(cases):
        for dtype in ("complex64", "complex128"):
            A, B = _direct_grids(l1, l2, n1, n2, device, seed=i, dtype=dtype)
            fwd, adj, dbl, _ = compare_direct_conv(A, B)
            tol = F32_IDENTITY_TOL if dtype == "complex64" else 1e-12
            ok = fwd <= tol and adj <= tol and dbl <= tol
            print(f"[direct] {dtype} {n1}x{n1} (*) {n2}x{n2}, F1 lead {l1}, F2 lead {l2}: "
                  f"forward rel {fwd:.3e}, adjoint rel {adj:.3e}, double backward rel "
                  f"{dbl:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
            check(ok, f"[direct] the kernel pair differs from its plain version at "
                      f"{n1}x{n2} {dtype}")
    n1, n2 = DIRECT_SIZES
    A, B = _direct_grids(lead, lead[:-1] + (1,), n1, n2, device, seed=99)
    fwd, adj, _, err = compare_direct_conv(A, B, second=False)
    a1, b1 = A[:1, :1].contiguous(), B[:1, :1].contiguous()
    _, _, dbl, _ = compare_direct_conv(a1, b1)
    ok = fwd <= F32_IDENTITY_TOL and adj <= F32_IDENTITY_TOL and dbl <= F32_IDENTITY_TOL
    print(f"[direct] served shape F1 {list(A.shape)} (*) F2 {list(B.shape)}: forward rel "
          f"{fwd:.3e} (max abs {err:.3e}), adjoint rel {adj:.3e}, double backward rel "
          f"{dbl:.3e} on one slot's edges (tol {F32_IDENTITY_TOL}) {'ok' if ok else 'FAIL'}")
    check(ok, "[direct] the kernel pair differs from its plain version at the served shape")
    a, b = A.detach().requires_grad_(True), B.detach().requires_grad_(True)
    reset_kernel_stats()
    out = full_conv(a, b)
    torch.autograd.grad(out, (a, b), torch.ones_like(out))
    stats = kernel_stats()
    print(f"[direct] one forward and backward at the served shape: direct_conv "
          f"{stats['direct_conv']}, direct_conv_adjoint {stats['direct_conv_adjoint']} "
          f"launches")
    if cuda:
        check(stats["direct_conv"] == 1 and stats["direct_conv_adjoint"] == 1,
              f"[direct] launches {stats}: not one forward and one adjoint")
    del out, a, b
    entry = {"max_abs_err": err, "ms": None, "adjoint_ms": None,
             "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None}
    if not cuda:
        return entry
    E, C = math.prod(lead[:-1]), lead[-1]
    A4, B4 = A.reshape(E, C, n1, n1), B.reshape(E, 1, n2, n2)
    N = n1 + n2 - 1
    G4 = torch.randn(E, C, N, N, dtype=A.dtype, device=device)
    fwd_k = device_ms(lambda: launch_full_conv(A4, B4))
    adj_k = device_ms(lambda: launch_adjoint(G4, B4.conj(), A4.conj(), C, 1))
    del G4
    ev_k = event_ms(lambda: launch_full_conv(A4, B4), reps=20)
    plain = event_ms(lambda: full_conv_plain(A, B), reps=5)
    library = event_ms(lambda: conv2d_full(A, B, "fft"), reps=5)
    el = A.element_size()
    nbytes = el * (A.numel() + B.numel() + E * C * N * N)
    flops = 8.0 * E * C * n1 * n1 * n2 * n2
    bound_ms, bound_by = bound_of(flops, nbytes)
    adj_bytes = el * (E * C * N * N + 2 * A.numel() + 2 * B.numel())
    adj_bound, adj_by = bound_of(2 * flops, adj_bytes)
    fwd_ms = fwd_k if fwd_k is not None else ev_k
    print(f"[times] direct conv {n1}x{n1} (*) {n2}x{n2}, {E:,} edges x {C} channels, "
          f"complex64: forward {fwd_ms:.4f} ms device ({'torch.profiler, 20 calls' if fwd_k is not None else 'CUDA events: the profiler saw no device time'}; "
          f"events {ev_k:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP), {bound_ms / fwd_ms * 100:.1f}% "
          f"of bound; adjoint (gA and the channel-summed gB) "
          + (f"{adj_k:.4f} ms device, bound {adj_bound:.4f} ms by {adj_by} "
             f"({adj_bytes / 1e9:.3f} GB), {adj_bound / adj_k * 100:.1f}% of bound"
             if adj_k is not None else "not measured")
          + f"; plain shift-and-add forward {plain:.3f} ms, conv2d_full fft route "
          f"{library:.3f} ms (CUDA events, median of 5)")
    print_registers("direct", "direct_conv")
    entry.update(ms=fwd_ms, adjoint_ms=adj_k, plain_ms=plain, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library)
    return entry


def phase_manybody(device, rows: int = MANYBODY_ROWS):
    """`plan(kind='manybody', Ls=(2, 2, 2), Lout=2)` pinned to each backend
    against the tree chain on the same operands, forward and gradients, ms
    per call; then `plan_batch` with two Ls buckets against per-plan
    calls."""
    import numpy as np
    import torch
    from repro_torch.core import engine as _engine

    Ls, Lout = (2, 2, 2), 2
    gen = torch.Generator(device=device).manual_seed(11)
    xs = [torch.randn(rows, 9, device=device, generator=gen) for _ in Ls]
    W = torch.randn(rows, 9, device=device, generator=gen)
    tree = _engine.plan_chain(Ls, Lout, backend="tree", device=device)

    def fwd_grad(apply):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        out = apply(leaves)
        return out.detach(), torch.autograd.grad((out * W).sum(), leaves)

    ref, ref_g = fwd_grad(lambda a: tree.apply(a))
    clock = "CUDA events, median of 50" if device.type == "cuda" else "not timed on the CPU"
    for backend in _engine.available_backends("manybody"):
        p = _engine.plan(kind="manybody", Ls=Ls, Lout=Lout, backend=backend, device=device)
        out, g = fwd_grad(p.apply)
        err = rel_err(out, ref)[1]
        gerr = _grad_err(g, ref_g)
        ms = event_ms(lambda: p.apply(xs)) if device.type == "cuda" else float("nan")
        print(f"[manybody] Ls={Ls} Lout={Lout} {rows} rows on {backend}: forward vs the tree "
              f"chain rel {err:.3e} (tol {F32_IDENTITY_TOL}), gradients rel {gerr:.3e} (tol "
              f"{F32_LOOSE_TOL}); {ms:.4f} ms a call ({clock})")
        check(err <= F32_IDENTITY_TOL and gerr <= F32_LOOSE_TOL,
              f"[manybody] the {backend} manybody plan differs from the tree chain")
    if device.type == "cuda":
        print(f"[manybody] the tree chain itself: {event_ms(lambda: tree.apply(xs)):.4f} ms a "
              f"call ({clock})")
    items = [_engine.BatchItem(Ls=Ls, Lout=Lout), _engine.BatchItem(Ls=(1, 2)),
             _engine.BatchItem(Ls=Ls, Lout=Lout)]
    bp = _engine.plan_batch(items, kind="manybody", device=device)
    ins = [xs, [torch.randn(rows // 2, 4, device=device, generator=gen), xs[0][: rows // 2]],
           [x[: rows // 4] for x in xs]]
    outs = bp.apply(ins)
    worst = 0.0
    for it, op, o in zip(items, ins, outs):
        p = _engine.plan(kind="manybody", Ls=it.Ls, Lout=it.Lout, backend=bp.buckets[
            0 if it.Ls == Ls else 1].plan.backend, device=device)
        worst = max(worst, rel_err(o, p.apply(op))[1])
    print(f"[manybody] plan_batch of {len(items)} items in {len(bp.buckets)} Ls buckets ("
          + ", ".join(f"{b.item_ids} -> {b.plan.backend}" for b in bp.buckets)
          + f"): vs per-plan calls rel {worst:.3e} (tol {BATCH_VS_PLAN_TOL})")
    check(len(bp.buckets) == 2 and worst <= BATCH_VS_PLAN_TOL,
          "[manybody] plan_batch differs from per-plan calls")


def phase_calibrate(device, sweep: bool = True):
    """`calibrate_fused` at f32 and bf16 (the factor, both times), the factor
    reloaded measured from the autotune cache by a fresh engine with zero
    timing runs; then the offline sweep (`--fast`) on a fresh engine and
    again with ``--verify-warm``, which must make zero timing runs."""
    import os
    import tempfile

    from repro_torch.core import autotune_cache
    from repro_torch.core import engine as _engine

    saved = _engine.get_calibration()
    ge = _engine.get_engine()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "calib.json")
            eng = _engine.GauntEngine(cache_path=path)
            for d in ("float32", "bfloat16"):
                t0 = time.perf_counter()
                rec = eng.calibrate_fused(dtype=d, device=device)
                print(f"[calibrate] calibrate_fused L={rec['L']} B={rec['B']} {d}: factor "
                      f"{rec['factor']} (fused_torch {rec['fused_torch_us']} us, dense_einsum "
                      f"{rec['dense_einsum_us']} us a call, median of 5, synchronised; "
                      f"{time.perf_counter() - t0:.2f} s)")
            check(eng.timing_runs == 2, "[calibrate] calibrate_fused is one timing run a dtype")
            measured = _engine.get_calibration()
            _engine.reset_calibration()
            warm = _engine.GauntEngine(cache_path=path)
            warm.load_autotune_cache()
            cal = _engine.get_calibration()
            ok = all(cal[k] == measured[k] for k in ("fused_skinny", "fused_skinny:bfloat16"))
            print(f"[calibrate] reloaded from the autotune file: fused_skinny "
                  f"{cal['fused_skinny']} measured {cal['fused_skinny_measured']}, bf16 "
                  f"{cal['fused_skinny:bfloat16']} measured "
                  f"{cal['fused_skinny:bfloat16_measured']}; {warm.timing_runs} timing runs")
            check(ok and cal["fused_skinny_measured"] and cal["fused_skinny:bfloat16_measured"]
                  and warm.timing_runs == 0, "[calibrate] the factors did not reload measured")
            if sweep:
                sweep_path = os.path.join(tmp, "sweep.json")
                argv = ["--fast", "--cache", sweep_path, "--device", device.type]
                for tag, extra in (("sweep", []), ("verify-warm", ["--verify-warm"])):
                    _engine.reset_calibration()
                    _engine._ENGINE = _engine.GauntEngine()
                    t0 = time.perf_counter()
                    rc = autotune_cache.main(argv + extra)
                    runs = _engine.get_engine().timing_runs
                    print(f"[calibrate] offline sweep ({tag}): exit {rc}, {runs} timing runs, "
                          f"{time.perf_counter() - t0:.2f} s")
                    check(rc == 0, f"[calibrate] the offline sweep ({tag}) exited {rc}")
                check(runs == 0, "[calibrate] --verify-warm made timing runs")
    finally:
        _engine._ENGINE = ge
        _engine.reset_calibration()
        _engine.set_calibration(**saved)


def phase_quickstart(device) -> dict:
    """The quickstart twin on the device: every max-abs error below 1e-5,
    its times printed beside the card."""
    from repro_torch.examples.quickstart import main as quickstart

    res = quickstart(device)
    worst = max(res["errors"].values())
    print(f"[quickstart] {len(res['errors'])} comparisons, worst max-abs error {worst:.3e} "
          f"(tol {QUICKSTART_TOL}); times "
          + ", ".join(f"{k} {v:.1f} us" for k, v in res["times_us"].items())
          + f" on {res['device']}")
    check(worst <= QUICKSTART_TOL, f"[quickstart] an error is above {QUICKSTART_TOL}: "
                                   f"{res['errors']}")
    return res


QUICKSTART_TOL = 1e-5


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


def chain_work(n_rows: int, ds, G: int, dout: int, gated: bool, sbytes: int = 4):
    """(FLOPs, bytes) the chain function needs at ``G`` distinct samples:
    each input byte read once, each output byte written once (T and P
    included); the rows and T at ``sbytes`` a value (the storage: 4 at f32,
    2 at bf16), P, the gate scalars and the output at 4."""
    n = len(ds)
    flops = n_rows * (2 * G * sum(ds) + G * (n - 1) + (2 * G if gated else 0)
                      + 2 * G * dout)
    nbytes = (sbytes * (n_rows * sum(ds) + sum(ds) * G)
              + 4 * (n_rows * (dout + (2 if gated else 0)) + G * dout))
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


def _per_call_us(events, reps: int, keep=None):
    """Device microseconds a call from the profiler's kernel events of
    ``reps`` calls (those ``keep`` accepts): each kernel's mean over the
    launches the profiler kept, times its launches a call (its count over
    ``reps``, rounded); None when a kernel kept under half of them.  The
    profiler now and then loses the first kernels of its window, so the
    summed time over ``reps`` would read low (16 of 20 calls kept: 0.8 of
    the time)."""
    total = 0.0
    for e in events:
        if keep is not None and not keep(e):
            continue
        launches = round(e.count / reps)
        if launches == 0:
            return None
        total += _device_us(e) / e.count * launches
    return total


def device_ms(fn, reps: int = 20):
    """GPU time per call from torch.profiler: the device time of the
    kernels ``fn`` launches, a call (`_per_call_us` over ``reps`` calls);
    None when two profiled runs in a row record no device time (then only
    the event times stand).  A profiled run now and then records none; the
    second is a retry."""
    for _ in range(2):
        us = _per_call_us(_profiled_kernels(fn, reps), reps)
        if us:
            return us / 1e3
    return None


def phase_times(device, rows: int, Ls=(2, 2, 2), Lout: int = 2, dtype: str = "float32"):
    """The chain kernel and its plain version on the folded matrices the
    route uses, at storage ``dtype`` (bf16: rows and T at bf16, P and the
    gate f32)."""
    import numpy as np
    import torch
    from repro_torch.core import constants as _c
    from repro_torch.kernels.gaunt_fused import chain_plain, launch_chain_kernel

    sdt = getattr(torch, dtype)
    # the matrices the chain route uses: folded to the distinct sphere points
    Ts_np, _ = _c.chain_matrices_folded(Ls, Lout, ("sh",) * len(Ls), "sh", dtype=dtype)
    P_np = _c.chain_matrices_folded(Ls, Lout, ("sh",) * len(Ls), "sh", dtype="float32")[1]
    Ts = [_c.to_torch(T, device, sdt) for T in Ts_np]
    P = _c.to_torch(P_np, device)
    rng = np.random.default_rng(0)
    flat = [torch.as_tensor(rng.normal(size=(rows, T.shape[0])), dtype=torch.float32,
                            device=device).to(sdt) for T in Ts]
    gs, gb = (torch.as_tensor(rng.normal(size=(rows, 1)), dtype=torch.float32,
                              device=device) for _ in range(2))
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1 = event_ms(lambda: chain_plain(flat, Ts, P, gs, gb))
    k1 = event_ms(lambda: launch_chain_kernel(flat, Ts, P, gs, gb))
    k2 = event_ms(lambda: launch_chain_kernel(flat, Ts, P, gs, gb))
    p2 = event_ms(lambda: chain_plain(flat, Ts, P, gs, gb))
    G, dout = P.shape
    full = _c.chain_matrices(Ls, Lout, ("sh",) * len(Ls), "sh", pad_lanes=False,
                             dtype="float64")[0]
    Gd = int(sample_classes(full).max()) + 1
    check(Gd == G, f"the folded chain grid has {G} samples, the sphere {Gd} distinct points")
    flops, nbytes = chain_work(rows, [T.shape[0] for T in Ts], Gd, dout, True,
                               sbytes=sdt.itemsize)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[times] chain {dtype} Ls={Ls} Lout={Lout} gated rows={rows} G={G} folded of "
          f"{full[0].shape[1]} torus samples: kernel "
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
    print(f"[times] work at the {Gd} distinct sphere points ({dtype} rows and T): "
          f"{flops / 1e6:.2f} MFLOP, {nbytes / 1e6:.3f} MB -> bound {bound_ms:.5f} ms "
          f"by {bound_by} (67 TFLOP/s f32, 3.35 TB/s); kernel at "
          f"{bound_ms / kernel_ms * 100:.1f}% of bound")
    print_registers("chain", "gaunt_chain")
    print("[times] library_ms: none — no single PyTorch call computes the chain "
          "collocation product")
    return kernel_ms, plain_ms, bound_ms, bound_by


def phase_pick_under_graph(device, model, buckets, tag):
    """Is each bucket's measured pick (timed eagerly, host launches
    included) still the faster chain once the step is a replayed graph?
    Per bucket, the step captured once with each candidate pinned, and each
    graph's replay timed (CUDA events, median of 50)."""
    from repro_torch.core import engine as _engine
    from repro_torch.serve.pools import SlotPool

    ge = _engine.get_engine()
    cfg = model.cfg
    for spec in buckets:
        probe = SlotPool(model, spec)
        key = _bucket_key(ge, cfg, probe, device)
        measured = ge.measured_pick(key)
        ms = {}
        for backend in ("tree", "fused_hopper"):
            with ge.pinned_chain(key, backend):
                pool = SlotPool(model, spec)
                fill_pool(pool, cfg.n_species, seed=1100 + spec.max_atoms)
                pool.warmup_compile()
                ms[backend] = event_ms(pool.step_staged)
                del pool
        best = min(ms, key=ms.get)
        print(f"[pick] {tag} bucket {spec.label()} ({key[3]} chain rows): graph replay "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f" (CUDA events, median of 50); eager pick {measured}, faster under the "
              f"graph {best}: {'same' if best == measured else 'DIFFERENT'}")


def serve_step_ms(model, n_slots, max_atoms, reps: int = 5) -> float:
    """Host-clock time of one full serve step through the engine (all slots
    occupied; the bucket's graph replayed), median."""
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


def profile_step(tag, setup, fn, top: int = 10) -> None:
    """One call of ``fn`` (a full serve step; ``setup`` fills its slots
    beforehand, outside the window) under torch.profiler: wall time, summed
    device time, the device's idle share, and the kernels that take the
    most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    setup()
    fn()
    setup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted(_kernel_events(prof), key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in events) / 1e3
    if busy <= 0:
        print(f"[profile] {tag}: the profiler saw no device time; step breakdown not measured")
        return
    print(f"[profile] {tag} (profiled): wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(e.count for e in events)} GPU events")
    for e in events[:top]:
        print(f"[profile]   {_device_us(e) / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    chain = sum(_device_us(e) for e in events if "gaunt_chain" in e.key) / 1e3
    print(f"[profile]   chain kernel: {chain:.3f} ms ({chain / busy * 100:.1f}% of busy)")


def profile_serve_steps(model, n_slots, max_atoms, tag) -> None:
    """The full serve step profiled twice on the same slots: through the
    engine (the bucket's graph replayed, then the host's retirements) and
    as the eager `SlotPool.evaluate` with its host copy."""
    from repro_torch.serve.engine import EquivariantServeEngine

    eng = EquivariantServeEngine(model, n_slots=n_slots, max_atoms=max_atoms, warmup=True)
    pool = eng.pools.pools[0]

    def admit():
        for r in make_requests([max_atoms] * n_slots, model.cfg.n_species, seed=900):
            check(eng.add_request(r), "no free slot for the profiled step")

    def eager():
        e, f = pool.evaluate(pool.species, pool.pos, pool.mask)
        e.cpu(), f.cpu()

    profile_step(f"serve step {tag} graph", admit, eng.step)
    admit()
    profile_step(f"serve step {tag} eager", lambda: None, eager)
    pool.evict()


# --------------------------------------------------------------------------
# phase 5: the pairwise path at full width
# --------------------------------------------------------------------------


def pair_work(n_rows: int, d1: int, d2: int, G: int, dout: int, sbytes: int = 4):
    """(FLOPs, bytes) the collocation algorithm needs at ``G`` distinct
    samples: each input byte read once (T1, T2 and P included), each output
    byte written once; the rows and T1, T2 at ``sbytes`` a value (4 at f32
    storage, 2 at bf16), P and the f32 output at 4."""
    flops = n_rows * (2 * G * (d1 + d2) + G + 2 * G * dout)
    nbytes = sbytes * (n_rows + G) * (d1 + d2) + 4 * (n_rows * dout + G * dout)
    return flops, nbytes


def pair_work_sparse(n_rows: int, Gt, sbytes: int = 4):
    """(FLOPs, bytes) of the sparse contraction over the nonzeros of the
    exact real Gaunt tensor ``Gt`` [d1, d2, dout] (float64): one product
    x1_i x2_j per (i, j) with a nonzero, then one FMA per nonzero; the rows
    (at ``sbytes`` a value) read and the f32 output written once, the
    nonzero values (at ``sbytes``) read once."""
    import numpy as np

    nz = np.abs(Gt) > 1e-9 * np.abs(Gt).max()  # roundoff of the exact builder is ~1e-16
    nnz, pairs = int(nz.sum()), int(nz.any(axis=-1).sum())
    d1, d2, dout = Gt.shape
    flops = n_rows * (pairs + 2 * nnz)
    nbytes = sbytes * (n_rows * (d1 + d2) + nnz) + 4 * n_rows * dout
    return flops, nbytes, nnz, pairs


def bound_of(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_pair_main(device, rows: int, dtype: str = "float32"):
    """`ops.gaunt_tp_fused` at (6, 6, 6) on ``rows`` rows at storage
    ``dtype`` (bf16: bf16 operands, the kernel's bf16 mode, a bf16 plan
    output), the kernel's launches counted over this run alone; checks
    against the dense oracle on a row subset and under rotation.  ->
    (launches, inputs)."""
    import torch
    from repro_torch.core import so3
    from repro_torch.core.cg import gaunt_einsum_reference
    from repro_torch.kernels.gaunt_fused import kernel_stats, reset_kernel_stats
    from repro_torch.kernels.ops import gaunt_tp_fused

    bf16 = dtype == "bfloat16"
    tag, stat = ("pairwise bf16", "gaunt_pair_bf16") if bf16 else ("pairwise", "gaunt_pair")
    tol_id, tol_tr, _ = TIERS[dtype]
    tol_eq = tol_tr if bf16 else PAIR_EQUIVARIANCE_TOL
    L1, L2, Lout = PAIR_MAIN
    x1, x2 = _pair_rows(L1, L2, rows, device, seed=2024, dtype=dtype)
    reset_kernel_stats()
    with torch.no_grad():
        out = gaunt_tp_fused(x1, x2, L1, L2, Lout, device=device, dtype=dtype)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_stats()[stat]
    print(f"[{tag}] ops.gaunt_tp_fused ({L1},{L2},{Lout}) on {rows} rows "
          f"(640 nodes x 128 channels at full width) -> {tuple(out.shape)} {out.dtype}, "
          f"{stat} launches {launches}")
    check(out.shape == (rows, (Lout + 1) ** 2), "pairwise output shape")
    check(bool(torch.isfinite(out).all()), "pairwise output is not finite")
    if device.type == "cuda":
        check(launches > 0, f"the pair kernel ({stat}) was not launched on the pairwise path")
    sub = slice(0, min(rows, 4096))
    want = gaunt_einsum_reference(x1[sub].double(), x2[sub].double(), L1, L2, Lout)
    err, rel = rel_err(out[sub], want)
    print(f"[{tag}] vs the dense Gaunt oracle (f64 on the same {dtype} operands, first "
          f"{want.shape[0]} rows): max_abs_err {err:.3e} rel {rel:.3e} (tol {tol_id})")
    check(rel <= tol_id, "pairwise output differs from the dense oracle")
    angles = (0.4, 1.3, -2.1)
    D1, D2, D3 = (torch.as_tensor(so3.wigner_D_real_packed(L, *angles), dtype=torch.float32,
                                  device=device) for L in (L1, L2, Lout))
    with torch.no_grad():
        rot = gaunt_tp_fused((x1.float() @ D1.T).to(x1.dtype), (x2.float() @ D2.T).to(x2.dtype),
                             L1, L2, Lout, device=device, dtype=dtype)
        want_rot = out.float() @ D3.T
    err, rel = rel_err(rot, want_rot)
    print(f"[{tag}] equivariance out(D x1, D x2) vs D out(x1, x2): max_abs_err "
          f"{err:.3e} rel {rel:.3e} (tol {tol_eq})")
    check(rel <= tol_eq, "pairwise product is not equivariant")
    return launches, (x1, x2)


def phase_pair_times(device, x1, x2):
    """Kernel and plain version at the full-width shape, in turns (plain,
    kernel, kernel, plain), at the storage of ``x1``/``x2`` (f32 or bf16),
    device times from torch.profiler, the bound of the exact algorithm with
    the fewest operations (operations at the f32 rate: the sums are f32;
    bytes at the storage's width), and the dense Gaunt contraction in
    library calls at the same storage."""
    import torch
    from repro_torch.core import constants as _c
    from repro_torch.core.engine import _gaunt_contract
    from repro_torch.kernels.gaunt_fused import (launch_pair_kernel, pair_kernel_constants,
                                                 pair_plain)

    L1, L2, Lout = PAIR_MAIN
    sdt = x1.dtype
    bf16 = sdt == torch.bfloat16
    name = "pair bf16" if bf16 else "pair"
    dts = str(sdt).replace("torch.", "")
    T1n, T2n, _ = _c.pair_matrices(L1, L2, Lout, dtype=dts)
    T1, T2 = (_c.to_torch(a, device, sdt if bf16 else None) for a in (T1n, T2n))
    P = _c.to_torch(_c.pair_matrices(L1, L2, Lout)[2], device)
    consts = pair_kernel_constants(L1, L2, Lout, device, sdt)
    rows, (d1, d2), (G, dout) = x1.shape[0], (x1.shape[1], x2.shape[1]), P.shape
    full = _c.chain_matrices((L1, L2), Lout, ("sh", "sh"), "sh", pad_lanes=False,
                             dtype="float64")[0]
    Gd = int(sample_classes(full).max()) + 1
    check(Gd == G, f"the folded grid has {G} samples, the sphere {Gd} distinct points")
    with torch.no_grad():
        p1 = event_ms(lambda: pair_plain(x1, x2, T1, T2, P))
        k1 = event_ms(lambda: launch_pair_kernel(x1, x2, *consts))
        k2 = event_ms(lambda: launch_pair_kernel(x1, x2, *consts))
        p2 = event_ms(lambda: pair_plain(x1, x2, T1, T2, P))
        kd = device_ms(lambda: launch_pair_kernel(x1, x2, *consts))
        pd = device_ms(lambda: pair_plain(x1, x2, T1, T2, P))
    print(f"[times] {name} ({L1},{L2},{Lout}) rows={rows} G={G} of {full[0].shape[1]} torus "
          f"samples: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms per call "
          f"(CUDA events around one call from Python, median of 50)")
    if kd is not None and pd is not None:
        kernel_ms, plain_ms = kd, pd
        print(f"[times] {name} device time per call (torch.profiler, 20 calls): kernel "
              f"{kd:.5f} ms, plain {pd:.5f} ms")
    else:
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        print(f"[times] {name} device time per call: not measured (the profiler saw no "
              "device time); the event times stand")
    # the bound is that of the exact algorithm with the fewest operations:
    # the collocation product at the distinct sphere points, or the sparse
    # contraction over the Gaunt tensor's nonzeros
    sb = sdt.itemsize
    flops_c, nbytes_c = pair_work(rows, d1, d2, G, dout, sbytes=sb)
    Gt = _c.gaunt_dense(L1, L2, Lout, "float64")
    flops_s, nbytes_s, nnz, pairs = pair_work_sparse(rows, Gt, sbytes=sb)
    bounds = [(*bound_of(f, b), f, b, what) for f, b, what in
              ((flops_c, nbytes_c, f"collocation at {G} distinct sphere points"),
               (flops_s, nbytes_s, f"sparse contraction over {nnz} nonzeros "
                                   f"({pairs} operand pairs)"))]
    for b_ms, b_by, f, b, what in bounds:
        print(f"[times] {name} work by {what}: {f / 1e9:.4f} GFLOP ({f // rows} per row), "
              f"{b / 1e6:.3f} MB ({dts} rows) -> {b_ms:.5f} ms by {b_by} (67 TFLOP/s f32, "
              f"3.35 TB/s)")
    bound_ms, bound_by, _, _, least = min(bounds)
    print(f"[times] {name} bound {bound_ms:.5f} ms by {bound_by} ({least}); kernel at "
          f"{bound_ms / kernel_ms * 100:.1f}% of bound")
    # tensor-core work after padding: the sampling (3xTF32 m16n8k8 at f32,
    # one bf16 m16n8k16 at bf16) and the 3xTF32 projection
    Gp, KT, NO = consts[0].shape[0] * 8, consts[0].shape[1] + consts[1].shape[1], \
        consts[2].shape[1]
    proj = 3 * 2 * rows * Gp * 8 * NO
    if bf16:
        samp = 2 * rows * Gp * 16 * KT
        print(f"[times] {name} kernel work: sampling {samp / 1e9:.2f} G bf16 FLOP "
              f"(d -> 16 x ceil(d/16)), projection {proj / 1e9:.2f} G TF32 FLOP (3xTF32), "
              f"G {G} -> {Gp}: {samp / kernel_ms / 1e9:.1f} bf16 + "
              f"{proj / kernel_ms / 1e9:.1f} TF32 TFLOP/s over the kernel's time")
    else:
        mma_flops = 3 * 2 * rows * Gp * 8 * KT + proj
        print(f"[times] {name} kernel work: 3xTF32 on tensor cores, {mma_flops / 1e9:.2f} G "
              f"TF32 FLOP after padding (G {G} -> {Gp}, d -> 8 x ceil(d/8)), "
              f"{mma_flops / kernel_ms / 1e9:.1f} TFLOP/s")
    print_registers(name, "gaunt_pair")
    # the library yardstick: the dense Gaunt contraction as one torch.einsum
    # call and as the two matmuls of the dense_einsum backend, at the rows'
    # dtype (bf16 in and out at bf16); the faster stands as library_ms (the
    # port's kernel route calls neither)
    Gf = _c.to_torch(_c.gaunt_dense(L1, L2, Lout, "float32"), device, sdt)
    lib = {"torch.einsum": lambda: torch.einsum("...i,...j,ijk->...k", x1, x2, Gf),
           "two matmuls": lambda: _gaunt_contract(x1, x2, Gf)}
    lib_ms = {}
    with torch.no_grad():
        for lname, fn in lib.items():
            ev = event_ms(fn)
            dv = device_ms(fn)
            lib_ms[lname] = dv if kd is not None and dv is not None else ev
            print(f"[times] {name} library {lname} ({dts}): {ev:.4f} ms per call (CUDA events, "
                  f"median of 50), device " + (f"{dv:.5f} ms" if dv is not None
                                               else "not measured"))
    library_name = min(lib_ms, key=lib_ms.get)
    library_ms = lib_ms[library_name]
    print(f"[times] {name} library_ms {library_ms:.5f} ({library_name}); kernel "
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


# --------------------------------------------------------------------------
# phases 8-10: the WKV6 kernel and the RWKV6 slice at full width
# --------------------------------------------------------------------------

# (name, B, T, H, K, V, chunk, decay, dtype of r, k, v): the reference's
# kernel tests (tests/test_kernels.py, K = 8 and 16), a prompt shorter than
# the chunk (C = T), the model's head size in f32 and in bf16 (as the model
# feeds r, k, v), many chunks on few (b, h) (the state pass's sequential
# loop: 32 chunks on 2 heads), decay near 1 and near-total forgetting
WKV_CASES = ([(f"K={K} T={T} chunk={c}", 2, T, 3, K, K, c, "uniform", "float32")
              for K in (8, 16) for T, c in ((32, 8), (64, 16), (48, 16))]
             + [("T<64 (C=T=40)", 2, 40, 3, 64, 64, 64, "uniform", "float32"),
                ("K=V=64", 2, 256, 4, 64, 64, 64, "uniform", "float32"),
                ("K=V=64 bf16", 2, 256, 4, 64, 64, 64, "uniform", "bfloat16"),
                ("many chunks", 1, 2048, 2, 64, 64, 64, "uniform", "float32"),
                ("w=0.999", 2, 256, 4, 64, 64, 64, "near_one", "float32"),
                ("w=1e-6 K=8", 1, 64, 1, 8, 8, 64, "extreme", "float32"),
                ("w=1e-6 K=64", 2, 128, 4, 64, 64, 64, "extreme", "float32")])
WKV_FULL = (4, 2048, 40, 64)  # rwkv6-3b prefill: 4 prompts x 2048 tokens, 40 heads of 64


def _wkv_inputs(B, T, H, K, V, decay, device, seed, dtype="float32"):
    """r, k, v, w, u as the reference's kernel tests draw them (seeded
    numpy): r, k ~ N(0, 0.25), v ~ N(0, 1), u ~ N(0, 0.09), w by
    ``decay``; the extreme case takes unit r, k and u = 0 as
    test_wkv6_extreme_decay_stable does.  r, k, v in ``dtype``, w and u in
    f32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    scale = 1.0 if decay == "extreme" else 0.5
    r = rng.normal(size=(B, T, H, K)) * scale
    k = rng.normal(size=(B, T, H, K)) * scale
    v = rng.normal(size=(B, T, H, V))
    if decay == "uniform":
        w = rng.uniform(0.2, 0.999, size=(B, T, H, K))
    else:
        w = np.full((B, T, H, K), 0.999 if decay == "near_one" else 1e-6)
    u = np.zeros((H, K)) if decay == "extreme" else rng.normal(size=(H, K)) * 0.3
    io = getattr(torch, dtype)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device).to(
        io if i < 3 else torch.float32) for i, a in enumerate((r, k, v, w, u)))


def compare_wkv6(r, k, v, w, u, chunk: int = 64):
    """The kernel route against the plain version on the same inputs ->
    (output abs err, output rel err, state rel err, both finite)."""
    import torch
    from repro_torch.kernels.wkv6 import wkv6_chunked, wkv6_hopper

    with torch.no_grad():
        o_k, S_k = wkv6_hopper(r, k, v, w, u, chunk=chunk, return_state=True)
        o_p, S_p = wkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=True)
    if r.device.type == "cuda":
        torch.cuda.synchronize()
    err, rel = rel_err(o_k, o_p)
    finite = bool(torch.isfinite(o_k).all()) and bool(torch.isfinite(S_k).all())
    return err, rel, rel_err(S_k, S_p)[1], finite


def phase_wkv6_vs_plain(device, full=WKV_FULL) -> float:
    """The WKV6 kernel (`wkv6_hopper` on the card) against `wkv6_chunked`,
    output and final state, at the reference's test shapes, the edge cases
    and the full-width shape; -> max abs error at the full-width shape."""
    import torch

    cases = WKV_CASES + [(f"full width {full}", *full, full[3], 64, "uniform", "float32")]
    full_err = 0.0
    for i, (name, B, T, H, K, V, chunk, decay, dtype) in enumerate(cases):
        r, k, v, w, u = _wkv_inputs(B, T, H, K, V, decay, device, seed=10 + i, dtype=dtype)
        err, rel, srel, finite = compare_wkv6(r, k, v, w, u, chunk)
        ok = finite and rel <= F32_IDENTITY_TOL and srel <= F32_IDENTITY_TOL
        print(f"[wkv6] {name} [B={B},T={T},H={H},K={K},V={V}] {dtype} r/k/v, chunk "
              f"{min(chunk, T)}: "
              f"o max_abs_err {err:.3e} rel {rel:.3e}, state rel {srel:.3e} (tol "
              f"{F32_IDENTITY_TOL}: f32, the same chunked sums in another order), "
              f"finite {finite} {'ok' if ok else 'FAIL'}")
        check(ok, f"the wkv6 kernel disagrees with its plain version ({name})")
        if name.startswith("full width"):
            full_err = err
        del r, k, v, w, u
    return full_err


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, device, reps: int) -> tuple[float, list[float]]:
    """Median host-clock time of ``fn`` (each call ends in a synchronize)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def phase_rwkv6(device, cfg, batch: int, seq: int, n_decode: int, check_seq: int,
                generator):
    """rwkv6-3b on random weights from ``generator``: prefill ``batch`` x
    ``seq`` tokens (the WKV kernel launched once per layer, counted over
    this run alone), then ``n_decode`` greedy decode steps; finite logits
    and state; decode after a ``check_seq``-token prefill against forward's
    logits at the next position (f32 at full depth, bf16 at 2 layers); the
    kernel against its plain
    version on the first layer's WKV inputs.  -> (launches, model, params,
    prompt tokens, layer-0 WKV inputs, their max abs error)."""
    import torch
    from repro_torch.kernels.wkv6 import kernel_stats, reset_kernel_stats
    from repro_torch.models import ssm, transformer
    from repro_torch.models.api import build_model, count_params
    from repro_torch.models.layers import norm_apply

    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(generator)
    _sync(device)
    n_params = count_params(cfg)
    print(f"[rwkv6] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.d_model // cfg.rwkv_head_k} heads of {cfg.rwkv_head_k}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype} compute, {n_params:,} {cfg.param_dtype} "
          f"parameters ({n_params * 4 / 1e9:.2f} GB), random init in "
          f"{time.perf_counter() - t0:.2f} s")
    gen_dev = generator.device
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                           device=gen_dev).to(device)
    # the slice's main path: one prefill, then greedy decode
    reset_kernel_stats()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": tokens}, seq + n_decode)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    tok = last[:, -1].argmax(-1, keepdim=True)
    decoded = [tok]
    for i in range(n_decode):
        logits, cache = model.decode_step(params, cache, tok,
                                          torch.full((batch,), seq + i, device=device))
        check(logits.shape == (batch, 1, cfg.vocab), "decode logits shape")
        check(bool(torch.isfinite(logits).all()), f"decode step {i}: non-finite logits")
        tok = logits[:, -1].argmax(-1, keepdim=True)
        decoded.append(tok)
    _sync(device)
    launches = kernel_stats()["wkv6"]
    H, K = cfg.d_model // cfg.rwkv_head_k, cfg.rwkv_head_k
    print(f"[rwkv6] prefill {batch} x {seq} tokens (first call, {t_prefill:.3f} s) + "
          f"{n_decode} greedy decode steps: wkv6 kernel launches {launches} "
          f"(expected {cfg.n_layers}, one per layer of the prefill, the WKV input "
          f"[{batch}, {seq}, {H}, {K}]); tokens of prompt 0: "
          f"{[int(t[0]) for t in decoded]}")
    check(last.shape == (batch, 1, cfg.vocab), "prefill logits shape")
    check(bool(torch.isfinite(last).all()), "prefill logits are not finite")
    shapes = {"last_x": (cfg.n_layers, batch, cfg.d_model),
              "wkv": (cfg.n_layers, batch, H, K, K),
              "cm_last_x": (cfg.n_layers, batch, cfg.d_model)}
    for name, a in cache.items():
        check(tuple(a.shape) == shapes[name], f"cache {name} shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a.float()).all()), f"cache {name} is not finite")
    if device.type == "cuda":
        check(launches == cfg.n_layers, f"the wkv6 kernel launched {launches} times "
                                        f"in one prefill, not {cfg.n_layers}")
    # prefill -> decode against forward.  The random-weight model amplifies
    # bf16 rounding with depth (the scan below prints how far its bf16 and
    # f32 forward logits drift apart), so the paths are held to the f32 tier
    # at full depth and to the bf16 tier at the reference test's depth of 2;
    # bf16 at full depth is printed.
    toks2 = torch.randint(0, cfg.vocab, (batch, check_seq + 64), generator=generator,
                          device=gen_dev).to(device)
    for dtype, n_layers, tol in (("float32", cfg.n_layers, F32_IDENTITY_TOL),
                                 (cfg.dtype, 2, BF16_IDENTITY_TOL),
                                 (cfg.dtype, cfg.n_layers, None)):
        rel_p, err_d, rel_d = prefill_decode_vs_forward(
            dataclasses.replace(cfg, dtype=dtype, n_layers=n_layers),
            dict(params, layers=params["layers"][:n_layers]), toks2, check_seq, device)
        print(f"[rwkv6] consistency, {dtype} compute, {n_layers} layers, {check_seq} tokens "
              f"(forward over {check_seq + 64}): prefill last logits vs forward rel "
              f"{rel_p:.3e}, decode_step after prefill vs forward at position {check_seq}: "
              f"max_abs_err {err_d:.3e} rel {rel_d:.3e} "
              + (f"(tol {tol}) {'ok' if max(rel_p, rel_d) <= tol else 'FAIL'}"
                 if tol is not None else "(not held to a tier: see above)"))
        if tol is not None:
            check(max(rel_p, rel_d) <= tol, f"prefill/decode differ from forward "
                                            f"({dtype}, {n_layers} layers)")
    # what the bf16 tier is measured against: bf16 vs f32 forward logits of
    # these weights, by depth
    gaps = []
    for n_layers in sorted({min(n, cfg.n_layers) for n in (1, 2, 4, 8, 16, cfg.n_layers)}):
        sub = dict(params, layers=params["layers"][:n_layers])
        logits = [build_model(dataclasses.replace(cfg, dtype=dt, n_layers=n_layers),
                              device=device).forward(sub, {"tokens": toks2})[0]
                  for dt in (cfg.dtype, "float32")]
        gaps.append(f"{n_layers} layers {rel_err(*logits)[1]:.3e}")
        del logits
    print(f"[rwkv6] {cfg.dtype} vs float32 forward logits of these random weights "
          f"({check_seq + 64} tokens), scale-relative, by depth: " + ", ".join(gaps))
    # the first layer's WKV inputs of this run's prompts
    p0 = params["layers"][0]
    hn = norm_apply(p0["ln1"], transformer._embed_tokens(params, cfg, tokens), "layernorm")
    r, k, v, w, _ = ssm.rwkv6_projections(p0["tm"], hn, cfg, ssm._shift(hn))
    wkv_in = (r, k, v, w, p0["tm"]["u"])
    err, rel, srel, finite = compare_wkv6(*wkv_in)
    ok = finite and rel <= F32_IDENTITY_TOL and srel <= F32_IDENTITY_TOL
    print(f"[rwkv6] layer 0 WKV inputs of this run {tuple(r.shape)} ({r.dtype} r, k, v; "
          f"{w.dtype} w): kernel vs plain o max_abs_err {err:.3e} rel {rel:.3e}, state rel "
          f"{srel:.3e} (tol {F32_IDENTITY_TOL}) {'ok' if ok else 'FAIL'}")
    check(ok, "the wkv6 kernel disagrees with its plain version on layer 0's inputs")
    return launches, model, params, tokens, wkv_in, err


def prefill_decode_vs_forward(cfg, params, tokens, n: int, device):
    """Forward over ``tokens`` [B, S]; prefill of the first ``n``, then one
    decode_step of token n -> (prefill last logits vs forward at n - 1: rel
    err, decode vs forward at n: abs err, rel err)."""
    import torch
    from repro_torch.models.api import build_model

    model = build_model(cfg, device=device)
    logits_all, _ = model.forward(params, {"tokens": tokens})
    check(bool(torch.isfinite(logits_all).all()), "forward logits are not finite")
    last, cache = model.prefill(params, {"tokens": tokens[:, :n]}, n + 1)
    step, _ = model.decode_step(params, cache, tokens[:, n:n + 1],
                                torch.full((tokens.shape[0],), n, device=device))
    rel_p = rel_err(last[:, 0], logits_all[:, n - 1])[1]
    return (rel_p, *rel_err(step[:, 0], logits_all[:, n]))


def wkv6_work(B: int, T: int, H: int, K: int, V: int, rkv_bytes: int = 4):
    """(FLOPs, bytes) of the WKV6 function: the sequential recurrence in
    rescaled form (S~ = S / prod w: one FMA per state entry to add k v^T,
    one per entry for r^T S~), 4 K V per (token, head), is the exact
    algorithm with the fewest operations; r, k, v (``rkv_bytes`` an element)
    and w, u (f32) read once, o and the final S (f32) written once."""
    flops = 4 * K * V * B * T * H
    nbytes = (rkv_bytes * B * T * H * (2 * K + V)
              + 4 * (B * T * H * (K + V) + H * K + B * H * K * V))
    return flops, nbytes


def _profiled_kernels(fn, reps: int):
    """The profiler's GPU-side events of ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _kernel_events(prof)


def _pass_ms(calls: dict, kernels: tuple, reps: int = 20):
    """Device time per call of a two-pass kernel, both passes and each,
    from one torch.profiler session over ``reps`` rounds of ``calls``
    ({element type of the kernels' inputs as their names spell it
    ('__nv_bfloat16', 'float'): a call}); ``kernels`` names the two passes
    (state pass, output pass) -> {type: (both, state pass, output pass)},
    or None when the profiler records no device time (`_per_call_us`)."""
    events = _profiled_kernels(lambda: [fn() for fn in calls.values()], reps)
    out = {}
    for t in calls:
        state, outp = (_per_call_us(events, reps, lambda e, n=name: f"{n}<{t}," in e.key
                                    or f"{n}<{t}>" in e.key) for name in kernels)
        if not state or not outp:
            return None
        out[t] = ((state + outp) / 1e3, state / 1e3, outp / 1e3)
    return out


WKV6_PASSES = ("wkv6_state_kernel", "wkv6_out_kernel")
SSD_PASSES = ("ssd_state_kernel", "ssd_out_kernel")


def phase_wkv6_times(device, r, k, v, w, u):
    """Kernel and plain version on the layer-0 inputs at full width in the
    model's dtypes (r, k, v as the model makes them, w and u f32), in turns
    (plain, kernel, kernel, plain); device times per call and per pass from
    torch.profiler; the kernel on f32 copies of r, k, v beside (what the
    wrapper fed it before it read bf16 in place); the bound at the dtypes
    read."""
    import torch
    from repro_torch.kernels.wkv6 import launch_wkv6_kernel, wkv6_chunked

    ins = (r, k, v, w, u)
    ins32 = tuple(a.float().contiguous() for a in ins)
    B, T, H, K = r.shape
    V = v.shape[3]
    with torch.no_grad():
        p1 = event_ms(lambda: wkv6_chunked(*ins, return_state=True), reps=10)
        k1 = event_ms(lambda: launch_wkv6_kernel(*ins))
        f1 = event_ms(lambda: launch_wkv6_kernel(*ins32))
        k2 = event_ms(lambda: launch_wkv6_kernel(*ins))
        p2 = event_ms(lambda: wkv6_chunked(*ins, return_state=True), reps=10)
        tname = "__nv_bfloat16" if r.dtype == torch.bfloat16 else "float"
        dev_ms = _pass_ms({tname: lambda: launch_wkv6_kernel(*ins),
                           "float": lambda: launch_wkv6_kernel(*ins32)}, WKV6_PASSES)
        pd = device_ms(lambda: wkv6_chunked(*ins, return_state=True), reps=5)
    kd, fd = (None, None) if dev_ms is None else (dev_ms[tname], dev_ms["float"])
    print(f"[times] wkv6 [{B},{T},{H},{K}] V={V} chunk 64, {r.dtype} r/k/v: kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms per call; kernel on f32 copies "
          f"of r/k/v {f1:.4f} ms (CUDA events around one call from Python, median of 50 "
          f"and 10)")
    if kd is not None and fd is not None and pd is not None:
        kernel_ms, plain_ms = kd[0], pd
        print(f"[times] wkv6 device time per call (torch.profiler, 20 and 5 calls): kernel "
              f"{kd[0]:.5f} ms (state pass {kd[1]:.5f}, output pass {kd[2]:.5f}), on f32 "
              f"copies {fd[0]:.5f} ms (state {fd[1]:.5f}, output {fd[2]:.5f}), plain "
              f"{pd:.5f} ms")
    else:
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        print("[times] wkv6 device time per call: not measured (the profiler saw no "
              "device time); the event times stand")
    flops, nbytes = wkv6_work(B, T, H, K, V, r.element_size())
    nbytes32 = wkv6_work(B, T, H, K, V)[1]
    bound_ms, bound_by = bound_of(flops, nbytes)
    print(f"[times] wkv6 work: {flops / 1e9:.3f} GFLOP (sequential recurrence, 4 K V per "
          f"(token, head)), {nbytes / 1e6:.1f} MB ({r.dtype} r, k, v in; f32 w, u in, o, S "
          f"out) -> bound {bound_ms:.5f} ms by {bound_by} (67 TFLOP/s f32, 3.35 TB/s); "
          f"kernel at {bound_ms / kernel_ms * 100:.1f}% of bound; with f32 r, k, v "
          f"{nbytes32 / 1e6:.1f} MB -> {bound_of(flops, nbytes32)[0]:.5f} ms")
    print("[times] wkv6 library_ms: none — no single PyTorch call computes the WKV6 "
          "recurrence")
    return kernel_ms, plain_ms, bound_ms, bound_by


def phase_lm_times(device, name: str, scan_name: str, kernel_keys: tuple, model, params,
                   tokens, n_decode: int, reps: int = 3):
    """Prefill and decode per token on the host clock, then one profiled
    prefill (device busy time, idle share, the scan kernel's share — the
    kernels whose name holds one of ``kernel_keys`` — and the top kernels)
    and one profiled decode step (busy time, idle share, copies, top
    kernels)."""
    import torch

    batch, seq = tokens.shape
    pre_ms, pre_all = host_ms(lambda: model.prefill(params, {"tokens": tokens}, seq), device,
                              reps)
    _, cache = model.prefill(params, {"tokens": tokens}, seq + n_decode + 1)
    tok = tokens[:, -1:]
    step_times = []
    for i in range(n_decode):
        pos = torch.full((batch,), seq + i, device=device)
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, pos)
        _sync(device)
        step_times.append((time.perf_counter() - t0) * 1e3)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    dec_ms = sorted(step_times)[len(step_times) // 2]
    print(f"[times] {name} prefill {batch} x {seq}: {pre_ms:.2f} ms host clock, median of "
          f"{reps} ({', '.join(f'{t:.2f}' for t in pre_all)}), "
          f"{batch * seq / pre_ms * 1e3:.0f} tokens/s; decode_step ({batch} sequences): "
          f"{dec_ms:.2f} ms per token, median of {n_decode}")
    pos = torch.full((batch,), seq + n_decode, device=device)
    wall, events, busy = _profiled_wall(lambda: model.decode_step(params, cache, tok, pos),
                                       device)
    del cache
    if busy > 0:
        keys = [(e.key.lower(), _device_us(e) / 1e3) for e in events]
        casts = sum(t for k, t in keys if "bfloat16_copy" in k)
        copies = sum(t for k, t in keys if "memcpy" in k
                     or ("copy" in k and "bfloat16_copy" not in k))
        print(f"[profile] {name} decode step (profiled): wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
              f"{sum(e.count for e in events)} GPU events; casts to bf16 {casts:.3f} ms, "
              f"other copies {copies:.3f} ms")
        for e in events[:5]:
            print(f"[profile]   {_device_us(e) / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    wall, events, busy = _profiled_wall(lambda: model.prefill(params, {"tokens": tokens}, seq),
                                       device)
    if busy <= 0:
        print("[profile] the profiler saw no device time; prefill breakdown not measured")
        return pre_ms, dec_ms
    scan = sum(_device_us(e) for e in events if any(k in e.key for k in kernel_keys)) / 1e3
    print(f"[profile] {name} prefill (profiled): wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(e.count for e in events)} GPU events; {scan_name} kernel {scan:.3f} ms "
          f"({scan / busy * 100:.1f}% of busy)")
    for e in events[:10]:
        print(f"[profile]   {_device_us(e) / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    return pre_ms, dec_ms


# --------------------------------------------------------------------------
# phases 11-13: the SSD kernel and the Zamba2 slice at full width
# --------------------------------------------------------------------------

# (name, Bt, T, H, P, G, N, chunk, decay, dtype): the reference's kernel
# tests (tests/test_kernels.py: Bt 2, H 4, P 8, G 2, N 16), a prompt
# shorter than the chunk (C = T), strong and weak decay at the model's head
# size, the model's own head, state and dtype, and 32 chunks on 2 (b, h)
# (the state pass's chunk chain at full depth on few blocks)
SSD_CASES = [("ref T=32 chunk=8", 2, 32, 4, 8, 2, 16, 8, "ref", "float32"),
             ("ref T=64 chunk=32", 2, 64, 4, 8, 2, 16, 32, "ref", "float32"),
             ("T<64 (C=T=40)", 2, 40, 4, 8, 2, 16, 64, "ref", "float32"),
             ("strong A=-8 dt<=5", 2, 256, 8, 64, 2, 64, 64, "strong", "float32"),
             ("weak A dt~-1e-4", 2, 256, 8, 64, 2, 64, 64, "weak", "float32"),
             ("P=N=64 bf16", 2, 256, 8, 64, 1, 64, 64, "model", "bfloat16"),
             ("32 chunks on 2 heads", 1, 2048, 2, 64, 1, 64, 64, "model", "bfloat16")]
# zamba2-2.7b prefill: 4 prompts x 2048 tokens, 80 SSD heads of 64, N 64, G 1
SSD_FULL = (4, 2048, 80, 64, 1, 64)
# (dt range, -A range) by decay: the reference's test draw; strong, weak;
# and roughly the model's (softplus of N(0, 1) logits, A_log over [1, 8])
_SSD_DECAY = {"ref": ((0.01, 0.2), (0.5, 2.0)), "strong": ((0.01, 5.0), (8.0, 8.0)),
              "weak": ((0.5, 1.5), (1e-4, 1e-4)), "model": ((0.1, 3.0), (1.0, 8.0))}


def _ssd_inputs(Bt, T, H, P, G, N, decay, dtype, device, seed):
    """x, dt, A, B, C, D (seeded numpy; x, B, C in ``dtype``, the rest f32):
    x, B, C, D ~ N(0, 1), dt and -A uniform over the ``decay`` ranges."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    (dt_lo, dt_hi), (a_lo, a_hi) = _SSD_DECAY[decay]
    arrs = (rng.normal(size=(Bt, T, H, P)), rng.uniform(dt_lo, dt_hi, size=(Bt, T, H)),
            -rng.uniform(a_lo, a_hi, size=(H,)), rng.normal(size=(Bt, T, G, N)),
            rng.normal(size=(Bt, T, G, N)), rng.normal(size=(H,)))
    out = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrs]
    for i in (0, 3, 4):
        out[i] = out[i].to(getattr(torch, dtype))
    return tuple(out)


def compare_mamba2(x, dt, A, B, C, D, chunk: int = 64):
    """The kernel route against the plain version on the same inputs ->
    (output abs err, output rel err, state rel err, both finite)."""
    import torch
    from repro_torch.kernels.mamba2 import mamba2_ssd_chunked, mamba2_ssd_hopper

    with torch.no_grad():
        y_k, h_k = mamba2_ssd_hopper(x, dt, A, B, C, D, chunk=chunk, return_state=True)
        y_p, h_p = mamba2_ssd_chunked(x, dt, A, B, C, D, chunk=chunk, return_state=True)
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    err, rel = rel_err(y_k, y_p)
    finite = bool(torch.isfinite(y_k).all()) and bool(torch.isfinite(h_k).all())
    return err, rel, rel_err(h_k, h_p)[1], finite


def phase_mamba2_vs_plain(device, full=SSD_FULL) -> float:
    """The SSD kernel (`mamba2_ssd_hopper` on the card) against
    `mamba2_ssd_chunked`, output and final state, at the reference's test
    shapes, the edge cases and the full-width shape; -> max abs error at
    the full-width shape."""
    cases = SSD_CASES + [(f"full width {full}", *full, 64, "model", "bfloat16")]
    full_err = 0.0
    for i, (name, Bt, T, H, P, G, N, chunk, decay, dtype) in enumerate(cases):
        ins = _ssd_inputs(Bt, T, H, P, G, N, decay, dtype, device, seed=40 + i)
        err, rel, hrel, finite = compare_mamba2(*ins, chunk=chunk)
        ok = finite and rel <= SSD_VS_PLAIN_TOL and hrel <= SSD_VS_PLAIN_TOL
        print(f"[mamba2] {name} [Bt={Bt},T={T},H={H},P={P},G={G},N={N}] {dtype} x/B/C, "
              f"chunk {min(chunk, T)}: y max_abs_err {err:.3e} rel {rel:.3e}, state rel "
              f"{hrel:.3e} (tol {SSD_VS_PLAIN_TOL}: f32, the same chunked sums in another "
              f"order, la summed in the same order), finite {finite} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"the mamba2_ssd kernel disagrees with its plain version ({name})")
        if name.startswith("full width"):
            full_err = err
        del ins
    return full_err


def phase_zamba2(device, cfg, batch: int, seq: int, n_decode: int, check_seq: int,
                 generator):
    """zamba2-2.7b on random weights from ``generator``: prefill ``batch`` x
    ``seq`` tokens (the SSD kernel launched once per Mamba-2 layer, counted
    over this run alone), then ``n_decode`` greedy decode steps; finite
    logits and state; decode after a ``check_seq``-token prefill against
    forward over ``check_seq`` + 64 tokens (whole chunks) read at
    ``check_seq`` (f32 at full depth, bf16 at one stage); the kernel against
    its plain version on the first layer's SSD inputs.  -> (launches, model,
    params, prompt tokens, layer-0 SSD inputs, their max abs error)."""
    import torch
    from repro_torch.kernels.mamba2 import kernel_stats, reset_kernel_stats
    from repro_torch.models import ssm, transformer
    from repro_torch.models.api import build_model, count_params
    from repro_torch.models.layers import norm_apply

    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(generator)
    _sync(device)
    n_params = count_params(cfg)
    d_in = cfg.ssm_expand * cfg.d_model
    H, P, N = d_in // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state
    n_stages = cfg.n_layers // cfg.attn_every
    print(f"[zamba2] {cfg.name}: {cfg.n_layers} Mamba-2 layers in {n_stages} stages of "
          f"{cfg.attn_every} + a shared attention block ({cfg.n_heads} heads of {cfg.hd}, "
          f"{cfg.act} MLP d_ff {cfg.d_ff}), d_model {cfg.d_model}, {H} SSD heads of {P}, "
          f"state {N}, vocab {cfg.vocab}, {cfg.dtype} compute, {n_params:,} "
          f"{cfg.param_dtype} parameters ({n_params * 4 / 1e9:.2f} GB), random init in "
          f"{time.perf_counter() - t0:.2f} s")
    gen_dev = generator.device
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                           device=gen_dev).to(device)
    # the slice's main path: one prefill, then greedy decode
    reset_kernel_stats()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": tokens}, seq + n_decode)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    tok = last[:, -1].argmax(-1, keepdim=True)
    decoded = [tok]
    for i in range(n_decode):
        logits, cache = model.decode_step(params, cache, tok,
                                          torch.full((batch,), seq + i, device=device))
        check(logits.shape == (batch, 1, cfg.vocab), "decode logits shape")
        check(bool(torch.isfinite(logits).all()), f"decode step {i}: non-finite logits")
        tok = logits[:, -1].argmax(-1, keepdim=True)
        decoded.append(tok)
    _sync(device)
    launches = kernel_stats()["mamba2_ssd"]
    print(f"[zamba2] prefill {batch} x {seq} tokens (first call, {t_prefill:.3f} s) + "
          f"{n_decode} greedy decode steps: mamba2_ssd kernel launches {launches} "
          f"(expected {cfg.n_layers}, one per Mamba-2 layer of the prefill, the scan input "
          f"[{batch}, {seq}, {H}, {P}]); tokens of prompt 0: "
          f"{[int(t[0]) for t in decoded]}")
    check(last.shape == (batch, 1, cfg.vocab), "prefill logits shape")
    check(bool(torch.isfinite(last).all()), "prefill logits are not finite")
    kv = (n_stages, batch, seq + n_decode, cfg.kv_heads, cfg.hd)
    shapes = {"mamba.conv": (cfg.n_layers, batch, cfg.ssm_conv - 1, d_in + 2 * N),
              "mamba.ssm": (cfg.n_layers, batch, H, P, N), "k": kv, "v": kv}
    leaves = {"mamba.conv": cache["mamba"]["conv"], "mamba.ssm": cache["mamba"]["ssm"],
              "k": cache["k"], "v": cache["v"]}
    for name, a in leaves.items():
        check(tuple(a.shape) == shapes[name], f"cache {name} shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a.float()).all()), f"cache {name} is not finite")
    del cache, leaves
    if device.type == "cuda":
        check(launches == cfg.n_layers, f"the mamba2_ssd kernel launched {launches} times "
                                        f"in one prefill, not {cfg.n_layers}")
    # prefill -> decode against forward.  Forward takes whole chunks of 64
    # past one chunk, so it runs over check_seq + 64 tokens and is read at
    # check_seq (causality makes the two equal).  As for RWKV6, the paths
    # are held to the f32 tier at full depth and to the bf16 tier at one
    # stage; bf16 at full depth is printed, with a depth scan of bf16 vs
    # f32 forward logits.
    toks2 = torch.randint(0, cfg.vocab, (batch, check_seq + 64), generator=generator,
                          device=gen_dev).to(device)

    def sub(n_layers):
        return (dataclasses.replace(cfg, n_layers=n_layers),
                dict(params, mamba=params["mamba"][:n_layers]))

    for dtype, n_layers, tol in (("float32", cfg.n_layers, F32_IDENTITY_TOL),
                                 (cfg.dtype, cfg.attn_every, BF16_IDENTITY_TOL),
                                 (cfg.dtype, cfg.n_layers, None)):
        c, p = sub(n_layers)
        rel_p, err_d, rel_d = prefill_decode_vs_forward(
            dataclasses.replace(c, dtype=dtype), p, toks2, check_seq, device)
        print(f"[zamba2] consistency, {dtype} compute, {n_layers} layers, {check_seq} tokens "
              f"(forward over {check_seq + 64}, read at {check_seq}): prefill last logits vs "
              f"forward rel {rel_p:.3e}, decode_step after prefill vs forward at position "
              f"{check_seq}: max_abs_err {err_d:.3e} rel {rel_d:.3e} "
              + (f"(tol {tol}) {'ok' if max(rel_p, rel_d) <= tol else 'FAIL'}"
                 if tol is not None else "(not held to a tier: see below)"))
        if tol is not None:
            check(max(rel_p, rel_d) <= tol, f"prefill/decode differ from forward "
                                            f"({dtype}, {n_layers} layers)")
    gaps = []
    for n_layers in sorted({min(n, cfg.n_layers) for n in (6, 12, 24, cfg.n_layers)}):
        c, p = sub(n_layers)
        logits = [build_model(dataclasses.replace(c, dtype=dt), device=device)
                  .forward(p, {"tokens": toks2})[0] for dt in (cfg.dtype, "float32")]
        gaps.append(f"{n_layers} layers {rel_err(*logits)[1]:.3e}")
        del logits
    print(f"[zamba2] {cfg.dtype} vs float32 forward logits of these random weights "
          f"({check_seq + 64} tokens), scale-relative, by depth: " + ", ".join(gaps))
    # the first layer's SSD inputs of this run's prompts
    p0 = params["mamba"][0]
    hn = norm_apply(p0["ln"], transformer._embed_tokens(params, cfg, tokens), cfg.norm)
    with torch.no_grad():
        _, _, scan = ssm.mamba2_scan_inputs(p0["m"], hn, cfg)
    err, rel, hrel, finite = compare_mamba2(*scan)
    ok = finite and rel <= SSD_VS_PLAIN_TOL and hrel <= SSD_VS_PLAIN_TOL
    print(f"[zamba2] layer 0 SSD inputs of this run {tuple(scan[0].shape)} ({scan[0].dtype} "
          f"x, B, C; {scan[1].dtype} dt, A dt down to {float((scan[2] * scan[1]).min()):.2f} "
          f"a step): kernel vs plain y max_abs_err {err:.3e} rel {rel:.3e}, state rel "
          f"{hrel:.3e} (tol {SSD_VS_PLAIN_TOL}) {'ok' if ok else 'FAIL'}")
    check(ok, "the mamba2_ssd kernel disagrees with its plain version on layer 0's inputs")
    return launches, model, params, tokens, scan, err


def mamba2_work(x, B):
    """(FLOPs, bytes) of the SSD function: the step recurrence in rescaled
    form, as `wkv6_work` counts it (the decay is one scalar per head and
    step, so h~ = h / prod a costs O(P) a token: one FMA per state entry to
    add (dt x) B^T, one per entry for y = h C), 4 P N per (token, head), is
    the exact algorithm with the fewest operations; x, B, C (in their
    dtype), dt, A and D read once, y and the final h written once in
    f32."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    flops = 4 * P * N * Bt * T * H
    nbytes = (x.element_size() * (Bt * T * H * P + 2 * Bt * T * G * N)
              + 4 * (Bt * T * H + 2 * H + Bt * T * H * P + Bt * H * P * N))
    return flops, nbytes


def phase_mamba2_times(device, x, dt, A, B, C, D, launches: int):
    """Kernel and plain version on the layer-0 inputs at full width, in turns
    (plain, kernel, kernel, plain); device times per call of both passes
    and of each, and of the plain version, from torch.profiler; the bound
    and the launches per prefill."""
    import torch
    from repro_torch.kernels.mamba2 import launch_mamba2_kernel, mamba2_ssd_chunked

    # x, B and C as the model hands them over: views of one conv output
    ins = (x, dt.contiguous(), A.contiguous(), B, C, D.contiguous())
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    with torch.no_grad():
        p1 = event_ms(lambda: mamba2_ssd_chunked(*ins, return_state=True), reps=10)
        k1 = event_ms(lambda: launch_mamba2_kernel(*ins))
        k2 = event_ms(lambda: launch_mamba2_kernel(*ins))
        p2 = event_ms(lambda: mamba2_ssd_chunked(*ins, return_state=True), reps=10)
        tname = "__nv_bfloat16" if x.dtype == torch.bfloat16 else "float"
        dev_ms = _pass_ms({tname: lambda: launch_mamba2_kernel(*ins)}, SSD_PASSES)
        pd = device_ms(lambda: mamba2_ssd_chunked(*ins, return_state=True), reps=5)
    print(f"[times] mamba2 [{Bt},{T},{H},{P}] G={G} N={N} {x.dtype} x/B/C chunk 64: kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms per call (CUDA events around "
          f"one call from Python, median of 50 and 10)")
    if dev_ms is not None and pd is not None:
        kd = dev_ms[tname]
        kernel_ms, plain_ms = kd[0], pd
        print(f"[times] mamba2 device time per call (torch.profiler, 20 and 5 calls): "
              f"kernel {kd[0]:.5f} ms (state pass {kd[1]:.5f}, output pass {kd[2]:.5f}), "
              f"plain {pd:.5f} ms")
    else:
        kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
        print("[times] mamba2 device time per call: not measured (the profiler saw no "
              "device time); the event times stand")
    flops, nbytes = mamba2_work(x, B)
    bound_ms, bound_by = bound_of(flops, nbytes)
    print(f"[times] mamba2 work: {flops / 1e9:.3f} GFLOP (rescaled step recurrence, 4 P N per "
          f"(token, head)), {nbytes / 1e6:.1f} MB ({x.dtype} x, B, C in; f32 dt, y, h) -> "
          f"bound {bound_ms:.5f} ms by {bound_by} (67 TFLOP/s f32, 3.35 TB/s); kernel at "
          f"{bound_ms / kernel_ms * 100:.1f}% of bound; {launches} launches per prefill "
          f"({launches * kernel_ms:.2f} ms of kernel time)")
    print("[times] mamba2 library_ms: none — no single PyTorch call computes the SSD scan")
    return kernel_ms, plain_ms, bound_ms, bound_by


# --------------------------------------------------------------------------
# phases 14-16: the LM serve engine (decode step a CUDA graph) and the
# attention families at full width
# --------------------------------------------------------------------------

LM_SLOTS, LM_MAX_LEN = 4, 512        # the engine of the served LM phases
LM_TIMING_REPS = 21                  # engine steps timed, graph and eager in turns
LM_FAMILY_BATCH, LM_FAMILY_SEQ, LM_FAMILY_STEPS = 2, 256, 4
# (arch, layers kept, why, bf16 layers held): full width everywhere; depth
# cut only where the f32 parameters would not fit in 80 GB.  bf16 compute,
# the families' served dtype, runs over the same f32 weights at the depth
# kept and is held there, except gemma-2b's: it normalises by (1 + scale)
# and the reference's init sets each scale to 1, a gain of 2 in every norm,
# under which bf16 rounding noise grows layer by layer past the bf16 tiers
# (the reference's own bf16 forward too: tests/test_torch_lm_bf16.py at 18
# layers).  Its bf16 figures are printed at every depth and held on the
# first 6 layers.
LM_FAMILIES = [("gemma-2b", None, "", 6), ("stablelm-3b", None, "", None),
               ("whisper-base", None, "", None),
               ("qwen1.5-32b", 8, "all 64 layers would be ~140 GB at f32", None),
               ("qwen2-vl-72b", 4, "all 80 layers would be ~290 GB at f32", None),
               ("dbrx-132b", 2, "all 40 layers would be ~530 GB at f32", None)]
LM_BF16_SWEEP = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16)  # depths printed below a cut
# a MoE's bf16 tokens that may part beyond their tier, each after a router
# pick flip (`repro_torch.testing.pick_flips`): twice the 11 of dbrx-132b's
# 530 that parted on an H100 (seed 3)
LM_BF16_MAX_PARTED = 22
# the int8 KV cache's greedy check at full width: the prompt of
# tests/test_kv_int8.py (2 x 24 tokens), 16 greedy tokens
INT8_PROMPT, INT8_GREEDY_TOKENS = 24, 16


def _kernel_module(name: str):
    """The module ``repro_torch.kernels.<name>``: the package's own name
    ``wkv6`` is the wrapper function, as in the reference."""
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


def _free_device() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _lm_requests(vocab: int, n: int, prompt: tuple, new_tokens: int, seed: int):
    """``n`` greedy requests with seeded prompts of prompt[0]..prompt[1] tokens."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, int(rng.integers(prompt[0], prompt[1] + 1)))
                    .tolist(), max_new_tokens=new_tokens, rid=i) for i in range(n)]


def _init_lm(device, cfg, tag: str):
    """A model of ``cfg`` on the card and its f32 random weights from
    ``torch.Generator(device).manual_seed(0)``."""
    import torch
    from repro_torch.models.api import build_model, count_params

    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    _sync(device)
    n = count_params(cfg)
    heads = f"{cfg.n_heads}/{cfg.kv_heads} heads of {cfg.hd}, " if cfg.n_heads else ""
    print(f"[{tag}] {cfg.name}: {cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{heads}d_ff {cfg.d_ff}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k} (d_ff {cfg.d_ff_expert}, "
             f"{cfg.n_shared_experts} shared)" if cfg.n_experts else "")
          + f", vocab {cfg.vocab}; {n:,} {cfg.param_dtype} parameters ({n * 4 / 1e9:.2f} GB), "
          f"random init in {time.perf_counter() - t0:.2f} s")
    return model, params


def _profiled_wall(fn, device):
    """One profiled call -> (wall ms, GPU kernel events by device time, busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted(_kernel_events(prof), key=_device_us, reverse=True)
    return wall, events, sum(_device_us(e) for e in events) / 1e3


def phase_lm_engine(device, tag: str, model, params, n_requests: int = 8,
                    prompt: tuple = (16, 64), new_tokens: int = 16,
                    reps: int = LM_TIMING_REPS) -> dict:
    """Serve ``n_requests`` seeded greedy requests through `ServeEngine`
    (LM_SLOTS slots, max_len LM_MAX_LEN) with its decode step a CUDA graph,
    and again through the eager step: identical tokens for every request;
    one step's logits and cache, graph against eager from the same cache;
    the engine step (4 active slots: stage, replay, argmax, host copy) as a
    graph and eager in turns, host clock, median of ``reps``; the served
    tokens/s; a profiled graph step and eager step.  -> the numbers."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import _leaves

    cfg = model.cfg
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, warmup=True)
    t_warm = time.perf_counter() - t0
    graphed = device.type == "cuda"
    check(not graphed or eng._graph is not None, "the engine captured no decode graph")
    reqs = _lm_requests(cfg.vocab, n_requests, prompt, new_tokens, seed=1)
    t0 = time.perf_counter()
    eng.run(reqs)
    _sync(device)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    n_prompt = sum(len(r.prompt) for r in reqs)
    check(all(r.done and not r.rejected and len(r.output) == new_tokens for r in reqs),
          f"{tag}: a request was not served in full")
    eager = ServeEngine(model, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, eager=True)
    reqs_e = _lm_requests(cfg.vocab, n_requests, prompt, new_tokens, seed=1)
    t0 = time.perf_counter()
    eager.run(reqs_e)
    _sync(device)
    wall_e = time.perf_counter() - t0
    same = all(a.output == b.output for a, b in zip(reqs, reqs_e))
    print(f"[lmserve] {tag}: {n_requests} requests ({n_prompt} prompt tokens, "
          f"{prompt[0]}-{prompt[1]} each; {new_tokens} new tokens each, greedy), {LM_SLOTS} "
          f"slots, max_len {LM_MAX_LEN}, {cfg.dtype} compute: "
          + (f"graph captured in {eng.capture_s:.3f} s (warmup {t_warm:.2f} s), graph memory "
             f"{eng.graph_bytes / 2**20:.1f} MiB, {eng.replays} replays; " if graphed else
             "eager (no graph off the card); ")
          + f"served {n_tok} tokens in "
          f"{wall:.3f} s ({n_tok / wall:.1f} tokens/s; eager engine {wall_e:.3f} s, "
          f"{n_tok / wall_e:.1f} tokens/s); graph == eager tokens for every request: "
          f"{'ok' if same else 'FAIL'}; tokens of request 0: {reqs[0].output}")
    check(same, f"{tag}: the graph engine's tokens differ from the eager engine's")
    # fill every slot with a long request, then one step's logits and cache
    # from the same cache, graph against eager
    for e in (eng, eager):
        for r in _lm_requests(cfg.vocab, LM_SLOTS, (16, 16), 10 ** 6, seed=2):
            check(e.add_request(r), "no free slot")
    toks = np.array([r.output[-1] for r in eng.slot_req], np.int64)
    pos = eng.pos + 1
    snap = [a.clone() for a in _leaves(eng.cache)]
    with torch.no_grad():
        lg = eng._run(eng._upload(toks[None], pos[None]), 0)[:, 0].clone()
        after_g = [a.clone() for a in _leaves(eng.cache)]
        for a, b in zip(_leaves(eng.cache), snap):
            a.copy_(b)
        le = eng.evaluate(toks, pos)[:, 0]
        err = float((lg - le).abs().max())
        cerr = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(after_g, _leaves(eng.cache)))
    print(f"[lmserve] {tag}: one step from the same cache, graph vs eager: logits max abs "
          f"diff {err:.3e}, cache max abs diff {cerr:.3e} (expected 0: the same kernels in "
          f"the same order)")
    check(err <= F32_IDENTITY_TOL * max(1.0, float(le.abs().max())) and cerr <= 1e-2,
          f"{tag}: the graph step differs from the eager step")
    del snap, after_g
    times = {"graph": [], "eager": []}
    for _ in range(reps):
        for name, e in (("graph", eng), ("eager", eager)):
            t0 = time.perf_counter()
            e.step()
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"[times] {tag} decode step per token ({LM_SLOTS} sequences; stage, step, argmax, "
          f"host copy; host clock, median of {reps}, in turns): graph {med['graph']:.3f} ms, "
          f"eager {med['eager']:.3f} ms (x{med['eager'] / med['graph']:.2f}); "
          f"{LM_SLOTS / med['graph'] * 1e3:.1f} tokens/s decoding")
    out = {"graph_ms": med["graph"], "eager_ms": med["eager"], "tok_s": n_tok / wall}
    for name, e in (("graph", eng), ("eager", eager)):
        w, events, busy = _profiled_wall(e.step, device)
        if busy <= 0:
            print(f"[profile] {tag} decode step {name}: the profiler saw no device time; "
                  f"busy and idle not measured")
            continue
        idle = max(0.0, 1 - busy / med[name])
        out[f"{name}_busy_ms"], out[f"{name}_idle"] = busy, idle
        print(f"[profile] {tag} decode step {name} (profiled): wall {w:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / w):.3f} of the profiled wall, "
              f"{idle:.3f} of the unprofiled median step; "
              f"{sum(ev.count for ev in events)} GPU events")
        for ev in events[:4]:
            print(f"[profile]   {_device_us(ev) / 1e3:8.3f} ms {ev.count:5d}x  {ev.key[:90]}")
    del eng, eager
    _free_device()
    return out


def lm_run(cfg, params, device, tag: str, B: int = LM_FAMILY_BATCH,
           S: int = LM_FAMILY_SEQ, n_steps: int = LM_FAMILY_STEPS, record: bool = False):
    """At ``cfg``'s compute dtype: forward over S + n_steps seeded tokens
    (vlm: with 3-axis positions3, text-like; encdec: seeded source frames);
    prefill of the first S; then ``n_steps`` decode steps.  -> dict(logits
    [B, T, V] of forward, aux, last [B, V] of prefill, steps [n_steps, B,
    V]); with ``record``, also routes = dict(forward=, run=) the MoE
    router's `RouterLog` of the forward and of prefill + decode steps."""
    import contextlib

    import torch
    from repro_torch.models.api import build_model
    from repro_torch.testing import RouterLog

    model = build_model(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(3)
    T = S + n_steps
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=g, device=device)
    extra = {}
    if cfg.family == "encdec":
        extra["source_embeds"] = torch.randn((B, cfg.max_source_len, cfg.d_model),
                                             generator=g, device=device)
    batch = dict(tokens=tokens, **extra)
    if cfg.family == "vlm":
        batch["positions3"] = torch.arange(T, device=device)[None, :, None].expand(B, T, 3)
    logs = {k: RouterLog() for k in ("forward", "prefill", "steps")}

    def recording(k):
        return logs[k] if record else contextlib.nullcontext()

    with recording("forward"):
        logits_all, aux = model.forward(params, batch)
    check(bool(torch.isfinite(logits_all).all()) and bool(torch.isfinite(aux)),
          f"{tag}: forward is not finite")
    with recording("prefill"):
        last, cache = model.prefill(params, dict(tokens=tokens[:, :S], **extra), T)
    steps = []
    for j in range(n_steps):
        with recording("steps"):
            step, cache = model.decode_step(params, cache, tokens[:, S + j:S + j + 1],
                                            torch.full((B,), S + j, device=device))
        steps.append(step[:, 0])
    out = dict(logits=logits_all, aux=float(aux), last=last[:, 0], steps=torch.stack(steps))
    if record:
        out["routes"] = dict(forward=logs["forward"],
                             run=RouterLog.sequence(logs["prefill"], logs["steps"]))
    return out


def lm_identity(r, S: int):
    """Prefill's last logits and each decode step of `lm_run`'s result
    against the forward at its position, per row: -> (err_p [B], err_d
    [n_steps, B]), each over max(1, max|forward logits there|)."""
    import torch

    err_p = _token_err(r["last"], r["logits"][:, S - 1])
    err_d = torch.stack([_token_err(r["steps"][j], r["logits"][:, S + j])
                         for j in range(r["steps"].shape[0])])
    return err_p, err_d


def lm_consistency(cfg, params, device, tag: str, B: int = LM_FAMILY_BATCH,
                   S: int = LM_FAMILY_SEQ, n_steps: int = LM_FAMILY_STEPS):
    """`lm_run`, each decode step held against forward at its position.
    -> (prefill rel, worst decode rel, forward aux), scale-relative."""
    r = lm_run(cfg, params, device, tag, B, S, n_steps)
    err_p, err_d = lm_identity(r, S)
    return float(err_p.max()), float(err_d.max()), r["aux"]


def phase_lm_main(device, cfg):
    """qwen2-0.5b at full width and depth: served through the engine (graph
    == eager), then at f32 compute the served tokens of 2 requests against
    the teacher-forced greedy argmax of `forward`."""
    import torch
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    model, params = _init_lm(device, cfg, "lmserve")
    out = phase_lm_engine(device, cfg.name, model, params)
    m32 = dataclasses.replace(cfg, dtype="float32")
    from repro_torch.models.api import build_model

    model32 = build_model(m32, device=device)
    reqs = _lm_requests(cfg.vocab, 2, (16, 64), 16, seed=3)
    ServeEngine(model32, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN).run(reqs)
    ok = True
    for r in reqs:
        toks = list(r.prompt)
        with torch.no_grad():
            for _ in range(r.max_new_tokens):
                logits, _ = model32.forward(params, {"tokens": [toks]})
                toks.append(int(logits[0, -1].argmax()))
        ok &= toks[len(r.prompt):] == r.output
    print(f"[lmserve] {cfg.name} float32 compute: the served greedy tokens of {len(reqs)} "
          f"requests (graph) vs the teacher-forced argmax of forward: "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "served tokens differ from the teacher-forced greedy forward")
    del model, params
    _free_device()
    print(f"[lmserve] {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return out


def lossless_cf(cfg) -> float:
    """A capacity factor at which no MoE entry can drop: C = ceil(T k / E *
    cf) >= T once cf >= E / k, and no expert takes more than T entries (one
    a token).  The reference's consistency test uses 8.0, lossless at its
    reduced 4 experts top-2; at 60 experts top-4 it is not."""
    return max(8.0, cfg.n_experts / cfg.top_k)


def phase_lm_moe(device, cfg):
    """qwen2-moe-a2.7b at full width and depth (f32 weights, ~57 GB): served
    through the graph (graph == eager); at f32 compute, one decode step after
    a 2 x 256 prefill against forward, at capacity_factor 8.0 (printed) and
    at a lossless capacity (held to the f32 tier)."""
    t_phase = time.perf_counter()
    model, params = _init_lm(device, cfg, "lmserve")
    out = phase_lm_engine(device, cfg.name, model, params, n_requests=4, prompt=(16, 32),
                          new_tokens=8, reps=11)
    for cf, held in ((8.0, False), (lossless_cf(cfg), True)):
        c = dataclasses.replace(cfg, capacity_factor=cf, dtype="float32")
        rel_p, rel_d, aux = lm_consistency(c, params, device, cfg.name, n_steps=1)
        ok = max(rel_p, rel_d) <= F32_IDENTITY_TOL
        print(f"[lmserve] {cfg.name} capacity_factor {cf} (C = "
              f"{moe_capacity_of(c, LM_FAMILY_SEQ + 1)} of {LM_FAMILY_SEQ + 1} tokens x top-"
              f"{c.top_k} in forward), float32 compute: prefill {LM_FAMILY_BATCH} x "
              f"{LM_FAMILY_SEQ} last logits vs forward rel {rel_p:.3e}; decode_step after "
              f"prefill vs forward at position {LM_FAMILY_SEQ}: rel {rel_d:.3e} "
              + (f"(tol {F32_IDENTITY_TOL}) {'ok' if ok else 'FAIL'}" if held else
                 "(not held: forward may drop entries that the one-token decode keeps)")
              + f"; forward aux loss {aux:.5f}")
        if held:
            check(ok, f"{cfg.name}: decode after prefill differs from forward")
    del model, params
    _free_device()
    print(f"[lmserve] {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return out


def moe_capacity_of(cfg, T: int) -> int:
    from repro_torch.models.moe import moe_capacity

    return moe_capacity(T, cfg.n_experts, cfg.top_k, cfg.capacity_factor)


def _greedy(model, params, tokens, n: int, max_len: int):
    """Prefill ``tokens``, then ``n`` greedy decode steps -> ([B, n + 1]
    tokens, each step's logits)."""
    import torch

    last, cache = model.prefill(params, {"tokens": tokens}, max_len)
    tok = last[:, 0].argmax(-1, keepdim=True)
    seq, logits = [tok], [last[:, 0]]
    S = tokens.shape[1]
    for i in range(n):
        step, cache = model.decode_step(params, cache, tok,
                                        torch.full((tokens.shape[0],), S + i,
                                                   device=tokens.device))
        tok = step[:, 0].argmax(-1, keepdim=True)
        seq.append(tok)
        logits.append(step[:, 0])
    return torch.cat(seq, dim=1), torch.stack(logits), cache


def phase_int8_cache(device, model, params, cfg):
    """The int8 KV cache against the model-dtype cache (``cfg``'s compute
    dtype) on the same weights: a 2 x INT8_PROMPT prefill, then
    INT8_GREEDY_TOKENS greedy steps on each.  Held: every prefilled cache
    row is within the quantizer's own bound of the model-dtype row (round to
    nearest at the float32 scale s, read back at the float16 scale: 0.5 s +
    127 |s - s_f16| an element); where the two greedy streams part, the
    token the model-dtype cache picked leads its runner-up by less than
    twice the int8 cache's logits deviation at that step (a near tie flipped
    by the quantization noise, not a wrong row).  Printed: the logits
    deviation before the streams part and how many greedy tokens agree."""
    import torch
    from repro_torch.models.api import build_model

    q8 = build_model(dataclasses.replace(cfg, kv_cache_dtype="int8"), device=device)
    toks = torch.randint(0, cfg.vocab, (LM_FAMILY_BATCH, INT8_PROMPT), device=device,
                         generator=torch.Generator(device=device).manual_seed(5))
    max_len = INT8_PROMPT + INT8_GREEDY_TOKENS
    seq_fp, lg_fp, c_fp = _greedy(model, params, toks, INT8_GREEDY_TOKENS, max_len)
    seq_q8, lg_q8, c_q8 = _greedy(q8, params, toks, INT8_GREEDY_TOKENS, max_len)
    check(c_q8["k"].dtype == torch.int8, "the int8 cache is not int8")
    nbytes = [sum(a.numel() * a.element_size() for a in c.values()) for c in (c_fp, c_q8)]
    worst = 0.0  # the prefilled rows: computed from the tokens alone, in both
    for n in ("k", "v"):
        ref = c_fp[n][:, :, :INT8_PROMPT].float()
        s32 = ref.abs().amax(-1).clamp_min(1e-6) / 127.0
        s16 = c_q8[n + "_scale"][:, :, :INT8_PROMPT].float()
        deq = c_q8[n][:, :, :INT8_PROMPT].float() * s16[..., None]
        bound = 0.5 * s32 + 127.0 * (s32 - s16).abs()
        worst = max(worst, float(((deq - ref).abs() / bound[..., None]).max()))
    # the first token that differs, and the deviation of the steps before it
    differ = (seq_fp != seq_q8).any(dim=0)
    j0 = int(differ.float().argmax()) if bool(differ.any()) else seq_fp.shape[1]
    dev = max(rel_err(lg_q8[j], lg_fp[j])[1] for j in range(min(j0 + 1, lg_fp.shape[0])))
    line = (f"[lmfamilies] {cfg.name} kv_cache_dtype='int8' vs the {cfg.dtype} cache "
            f"({LM_FAMILY_BATCH} x {INT8_PROMPT} prefill, {INT8_GREEDY_TOKENS} greedy steps): "
            f"prefilled rows within the quantizer's bound (worst {worst:.3f} of it); logits "
            f"scale {float(lg_fp.abs().max()):.2f}, deviation up to the first differing step "
            f"rel {dev:.3e}; greedy tokens equal {int((~differ).sum())} of {seq_fp.shape[1]}")
    flip_ok = True
    if j0 < seq_fp.shape[1]:
        top2 = lg_fp[j0].topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        d = (lg_fp[j0] - lg_q8[j0]).abs().amax(-1)
        split = seq_fp[:, j0] != seq_q8[:, j0]
        flip_ok = bool((margin[split] <= 2 * d[split]).all())
        line += (f"; they part at step {j0}: the model-dtype pick leads by "
                 f"{float(margin[split].max()):.3e}, the int8 logits deviate by "
                 f"{float(d[split].max()):.3e} (a near tie: {'ok' if flip_ok else 'FAIL'})")
    print(line + f"; cache bytes {nbytes[1]:,} vs {nbytes[0]:,} ({nbytes[1] / nbytes[0]:.3f})")
    check(worst <= 1.0 + 1e-5, "an int8 cache row is outside the quantizer's bound")
    check(flip_ok, "the int8 cache changed a greedy token that was no near tie")


def _token_err(got, ref):
    """max |got - ref| over the last axis per token, over max(1, max|ref|):
    the tokens' shares of `rel_err`."""
    return (got.double() - ref.double()).abs().amax(-1) / max(1.0, float(ref.abs().max()))


def _flip_before(flips, b: int, t: int):
    """The latest explained pick flip of `pick_flips`'s result that can
    reach position t of row b: at t, at any layer; or at an earlier
    position of the row at a layer before the last, whose change a later
    layer's attention carries to t.  -> (layer, position, margin, bound) or
    None."""
    import torch

    flip, margin, bound = (a[:, b, :t + 1] for a in flips)
    ok = flip & (margin <= bound)
    ok[-1, :t] = False
    if not bool(ok.any()):
        return None
    pos = int(torch.nonzero(ok.any(0)).max())
    layer = int(torch.nonzero(ok[:, pos])[0])
    return layer, pos, float(margin[layer, pos]), float(bound[layer, pos])


def _hold_bf16(cfg, r16, r32, tag: str, S: int):
    """Holds `lm_run`'s bf16 result ``r16``: prefill's last logits and the
    decode steps against the bf16 forward at each position
    (BF16_IDENTITY_TOL), the bf16 forward against the f32 forward ``r32``
    per token (BF16_LOOSE_TOL).  For a MoE (both runs recorded), a token
    beyond its tier passes only after a router pick flip between the two
    runs it compares that can reach it (`_flip_before`), under the bound of
    the runs' measured router-input difference (`pick_flips`); every flip
    must be under it, and at most LM_BF16_MAX_PARTED tokens part."""
    from repro_torch.testing import pick_flips

    err_p, err_d = lm_identity(r16, S)
    err_f = _token_err(r16["logits"], r32["logits"])
    n = err_d.shape[0]
    # (what, tolerance, error, row, position) of every token compared
    sites = [("prefill", BF16_IDENTITY_TOL, float(err_p[b]), b, S - 1) for b in range(len(err_p))]
    sites += [(f"decode {j}", BF16_IDENTITY_TOL, float(err_d[j, b]), b, S + j)
              for j in range(n) for b in range(err_d.shape[1])]
    sites += [("vs f32", BF16_LOOSE_TOL, e, b, t)
              for b, row in enumerate(err_f.tolist()) for t, e in enumerate(row)]
    parted = [x for x in sites if x[2] > x[1]]
    line = (f"[lmfamilies] {tag} bfloat16 compute ({cfg.n_layers} layers, the f32 weights): "
            f"prefill {err_p.shape[0]} x {S} last logits vs the bf16 forward rel "
            f"{float(err_p.max()):.3e}; {n} decode steps vs the bf16 forward: worst rel "
            f"{float(err_d.max()):.3e} (tol {BF16_IDENTITY_TOL}); bf16 forward vs the f32 "
            f"forward rel {float(err_f.max()):.3e} (tol {BF16_LOOSE_TOL}); forward aux "
            f"{r16['aux']:.5f}")
    if "routes" not in r16:
        print(line + f"; {'ok' if not parted else 'FAIL'}")
        check(not parted, f"{tag}: bf16 compute outside its tiers at {len(parted)} tokens")
        return
    # the f32 forward against the bf16 forward; the bf16 forward against
    # the bf16 prefill and decode steps
    flips = {"vs f32": pick_flips(r32["routes"]["forward"], r16["routes"]["forward"]),
             "cache": pick_flips(r16["routes"]["forward"], r16["routes"]["run"])}
    unexplained = {k: int((f & (m > bd)).sum()) for k, (f, m, bd) in flips.items()}

    def flip_for(what, b, t):
        return _flip_before(flips["vs f32" if what == "vs f32" else "cache"], b, t)

    reach = sum(flip_for(what, b, t) is not None for what, _, _, b, t in sites)
    before = [flip_for(what, b, t) for what, _, _, b, t in parted]
    ok = all(x is not None for x in before) and len(parted) <= LM_BF16_MAX_PARTED
    print(line + f"; tokens parting beyond their tier: {len(parted)} of {len(sites)} (at most "
          f"{LM_BF16_MAX_PARTED}), each after an explained pick flip that can reach it: "
          f"{'ok' if ok else 'FAIL'}; tokens such a flip reaches: {reach} of {len(sites)}")
    for k, (f, m, bd) in flips.items():
        print(f"[lmfamilies] {tag} bf16 router, {k}: the two runs pick different experts at "
              f"{int(f.sum())} of {f.numel()} (layer, token) sites, {unexplained[k]} of them "
              f"past the bound of the runs' measured router-input difference")
    for (what, tol, e, b, t), fb in zip(parted, before):
        print(f"[lmfamilies] {tag} bf16 {what}: row {b} position {t} parts at {e:.3e} "
              f"(tol {tol}); " + ("no explained pick flip reaches it: FAIL" if fb is None
                                  else "the pick flip closest before it: layer {} position {}: "
                                  "margin {:.3e}, bound {:.3e}".format(*fb)))
    check(not any(unexplained.values()), f"{tag}: a bf16 router pick flip is past its bound")
    check(all(x is not None for x in before),
          f"{tag}: a bf16 token parts with no explained pick flip before it")
    check(len(parted) <= LM_BF16_MAX_PARTED,
          f"{tag}: {len(parted)} bf16 tokens part, more than {LM_BF16_MAX_PARTED}")


def phase_lm_bf16(device, cfg, params, r32, tag: str, seq: int, held: int | None = None):
    """The family at its served compute dtype, bf16, over the same f32
    weights, against `lm_run`'s f32 result ``r32`` (`_hold_bf16`).  With
    ``held`` under the depth: the full depth's figures and those of each
    LM_BF16_SWEEP prefix of the same weights are printed, and the first
    ``held`` layers are held.  -> seconds taken."""
    t0 = time.perf_counter()
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    r16 = lm_run(c16, params, device, tag, S=seq, record=cfg.family == "moe")
    if held is None or held >= cfg.n_layers:
        _hold_bf16(cfg, r16, r32, tag, seq)
        return time.perf_counter() - t0
    print(f"[lmfamilies] {tag} bfloat16 compute: figures at each depth of the same weights "
          f"(printed; held on the first {held} layers below)")
    for depth in sorted({d for d in LM_BF16_SWEEP + (held,) if d < cfg.n_layers}) + [cfg.n_layers]:
        pk = dict(params, layers=params["layers"][:depth])
        ck = dataclasses.replace(cfg, n_layers=depth)
        a32 = r32 if depth == cfg.n_layers else lm_run(ck, pk, device, tag, S=seq)
        a16 = r16 if depth == cfg.n_layers else lm_run(
            dataclasses.replace(ck, dtype="bfloat16"), pk, device, tag, S=seq)
        err_p, err_d = lm_identity(a16, seq)
        rel_f = float(_token_err(a16["logits"], a32["logits"]).max())
        within = (max(float(err_p.max()), float(err_d.max())) <= BF16_IDENTITY_TOL
                  and rel_f <= BF16_LOOSE_TOL)
        print(f"[lmfamilies] {tag} bfloat16 depth {depth}: prefill vs the bf16 forward rel "
              f"{float(err_p.max()):.3e}; decode steps worst rel {float(err_d.max()):.3e}; bf16 "
              f"forward vs the f32 forward rel {rel_f:.3e} "
              f"({'within' if within else 'outside'} the bf16 tiers)")
        if depth == held:
            _hold_bf16(ck, a16, a32, tag, seq)
    return time.perf_counter() - t0


def phase_lm_families(device, reduced: bool = False, seq: int = LM_FAMILY_SEQ):
    """The attention families at full width (depth cut only where 80 GB
    forces it): prefill 2 x 256, then 4 decode steps each held against
    forward at f32 compute; then at bf16 compute over the same weights
    (`phase_lm_bf16`); gemma-2b's int8 KV cache against its f32 cache over
    16 greedy tokens.  ``reduced``: each arch's reduced config, uncut and
    held whole (a rehearsal off the card, with a ``seq`` inside its
    max_seq)."""
    import torch
    from repro_torch.config import get_config

    t_all = time.perf_counter()
    for arch, keep, why, held in LM_FAMILIES:
        t_phase = time.perf_counter()
        full = get_config(arch).reduced() if reduced else get_config(arch)
        keep, held = (None, None) if reduced else (keep, held)
        cfg = dataclasses.replace(full, dtype="float32")
        if full.family == "moe":  # no entry may drop, as in the reference's consistency test
            cfg = dataclasses.replace(cfg, capacity_factor=lossless_cf(cfg))
        if keep is not None:
            cfg = dataclasses.replace(cfg, n_layers=keep)
            print(f"[lmfamilies] {arch}: depth cut to {keep} of {full.n_layers} layers ({why}); "
                  f"widths as published")
        model, params = _init_lm(device, cfg, "lmfamilies")
        r32 = lm_run(cfg, params, device, arch, S=seq, record=cfg.family == "moe")
        err_p, err_d = lm_identity(r32, seq)
        rel_p, rel_d = float(err_p.max()), float(err_d.max())
        ok = max(rel_p, rel_d) <= F32_IDENTITY_TOL
        print(f"[lmfamilies] {arch} float32 compute: prefill {LM_FAMILY_BATCH} x "
              f"{seq}" + (f" (source {cfg.max_source_len} frames)"
                                    if cfg.family == "encdec" else "")
              + (" (positions3 [B,T,3])" if cfg.family == "vlm" else "")
              + f": last logits vs forward rel {rel_p:.3e}; {LM_FAMILY_STEPS} decode steps vs "
              f"forward at each position: worst rel {rel_d:.3e} (tol {F32_IDENTITY_TOL}) "
              f"{'ok' if ok else 'FAIL'}; forward aux {r32['aux']:.5f}")
        check(ok, f"{arch}: decode after prefill differs from forward")
        t_bf16 = phase_lm_bf16(device, cfg, params, r32, arch, seq, held)
        print(f"[lmfamilies] {arch} bfloat16 compute added {t_bf16:.1f} s")
        del r32
        if cfg.family == "vlm":  # the three position axes apart (a vision-like grid)
            T = 64
            ar = torch.arange(T, device=device)
            p3 = torch.stack([ar // 16, (ar // 4) % 4, ar % 4], dim=-1)[None].expand(2, T, 3)
            toks = torch.randint(0, cfg.vocab, (2, T), device=device,
                                 generator=torch.Generator(device=device).manual_seed(4))
            l3, _ = model.forward(params, {"tokens": toks, "positions3": p3})
            lt, _ = model.forward(params, {"tokens": toks})
            check(bool(torch.isfinite(l3).all()), "vlm forward with 3-axis positions3")
            print(f"[lmfamilies] {arch}: forward with 3 distinct position axes: finite, "
                  f"rel to text positions {rel_err(l3, lt)[1]:.3e} (M-RoPE moves them)")
        if arch == "gemma-2b":
            phase_int8_cache(device, model, params, cfg)
        del model, params
        _free_device()
        print(f"[lmfamilies] {arch} phase {time.perf_counter() - t_phase:.1f} s")
    print(f"[lmfamilies] all families {time.perf_counter() - t_all:.1f} s")


# --------------------------------------------------------------------------
# phase 16: LM training
# --------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12             # H100 SXM dense bf16 (NVIDIA data sheet, 700 W)
LMTRAIN_BATCH, LMTRAIN_SEQ = 2, 2048  # qwen2-0.5b: 2 x 2 flash tiles of attn_chunk 1024
LMTRAIN_STEPS, LMTRAIN_CKPT_AT = 6, 3
LMTRAIN_TIMED, LMTRAIN_WARM = 5, 2
SCAN_TRAIN_STEPS = 3                 # RWKV6-3B and Zamba2-2.7B, batch 1 x 2048


def _reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    """Peak bytes allocated on the card since the last reset (0 off it)."""
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _allocated(device) -> int:
    import torch

    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def _card_bytes(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).total_memory if device.type == "cuda" else 0


def _lm_loss_fn(m, batch):
    return m.loss(batch)


def _lm_batch(cfg, batch: int, seq: int, device, seed: int = 0):
    """One LMTokenPipeline batch on the card (tokens == labels, int32 as
    the pipeline makes them)."""
    import torch
    from repro_torch.data import LMTokenPipeline

    b = LMTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                        seed=seed).next_batch()
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def _profiled_step(fn, device):
    """One call profiled on the card's timeline alone (the steps launch
    ~10^5 kernels; host-side events would take minutes to parse) -> (wall
    ms, GPU events by device time, busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    t0 = time.perf_counter()
    if device.type != "cuda":  # a rehearsal off the card: no device timeline
        fn()
        return (time.perf_counter() - t0) * 1e3, [], 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted(_kernel_events(prof), key=_device_us, reverse=True)
    return wall, events, sum(_device_us(e) for e in events) / 1e3


def _timed_steps(step_fn, module, opt_state, batch, device, n: int):
    """``n`` training steps, each ended by a host read of its loss -> (host
    ms of each, the last metrics, the optimizer state)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        opt_state, m = step_fn(module, opt_state, batch)
        float(m["loss"])
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, m, opt_state


def _print_profile(tag, wall, events, busy, step_ms, extra=""):
    if busy <= 0:
        print(f"[profile] {tag}: the profiler saw no device time; busy and idle not measured")
        return None
    idle = max(0.0, 1 - busy / step_ms)
    print(f"[profile] {tag} (profiled): wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
          f"share {idle:.3f} of the unprofiled median step; "
          f"{sum(ev.count for ev in events)} GPU events" + extra)
    for ev in events[:6]:
        print(f"[profile]   {_device_us(ev) / 1e3:8.3f} ms {ev.count:5d}x  {ev.key[:90]}")
    return idle


def lm_train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model flops of one training step: 6 N a token for the weights, plus
    the attention products at PaLM's count, 12 L H hd S a token (the whole
    S x S square, forward and backward; remat's recompute not counted)."""
    tokens = batch * seq
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.hd * seq if cfg.n_heads else 0
    return 6.0 * n_params * tokens + attn * tokens


def phase_lm_train_main(device, cfg, batch: int = LMTRAIN_BATCH, seq: int = LMTRAIN_SEQ):
    """qwen2-0.5b (the slice's main path): `train_loop` over `LMModule` on
    `LMTokenPipeline` batches, bf16 compute over f32 weights, remat on: 3
    AdamW steps with a checkpoint at step 3, then a fresh module resumed
    from it to step 6; finite losses and gradient norms; then the step time
    (host clock, median of LMTRAIN_TIMED after LMTRAIN_WARM warm steps),
    peak memory, a profiled step and the model-flops share."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.data import LMTokenPipeline
    from repro_torch.models.api import LMModule, count_params
    from repro_torch.train import make_train_step, train_loop

    t_phase = time.perf_counter()
    model, params = _init_lm(device, cfg, "lmtrain")
    n_params = count_params(cfg)
    tcfg = TrainConfig(lr=3e-4, warmup_steps=2, total_steps=LMTRAIN_CKPT_AT,
                       checkpoint_every=LMTRAIN_CKPT_AT, log_every=1)
    hist, marks = [], []

    def log(m):
        hist.append(m)
        marks.append(time.perf_counter())
        print(f"[lmtrain] {cfg.name} step {m['step']} loss {m['loss']:.4f} ce {m['ce']:.4f} "
              f"grad_norm {m['grad_norm']:.4f}")

    with tempfile.TemporaryDirectory() as ck:
        pipe = LMTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
        t0 = time.perf_counter()
        train_loop(_lm_loss_fn, LMModule(cfg, params), pipe, tcfg, ckpt_dir=ck,
                   hooks={"log": log})
        t_first = time.perf_counter() - t0
        del params
        _free_device()
        fresh = model.init(torch.Generator(device=device).manual_seed(1))
        pipe2 = LMTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
        t0 = time.perf_counter()
        state, _ = train_loop(_lm_loss_fn, LMModule(cfg, fresh), pipe2,
                              dataclasses.replace(tcfg, total_steps=LMTRAIN_STEPS),
                              ckpt_dir=ck, hooks={"log": log})
        t_second = time.perf_counter() - t0
    steps = [int(m["step"]) for m in hist]
    print(f"[lmtrain] {cfg.name}: {batch} x {seq} tokens a step ({cfg.dtype} compute, "
          f"remat {cfg.remat}, flash attention on {seq // cfg.attn_chunk} x "
          f"{seq // cfg.attn_chunk} tiles): steps {steps}; the run stopped at step "
          f"{LMTRAIN_CKPT_AT} with its checkpoint ({t_first:.1f} s) and a fresh module resumed "
          f"from it to step {state.step} ({t_second:.1f} s), the pipeline at step {pipe2.step}")
    check(steps == list(range(1, LMTRAIN_STEPS + 1)) and state.step == LMTRAIN_STEPS
          and pipe2.step == LMTRAIN_STEPS, f"{cfg.name}: the run did not resume to step "
          f"{LMTRAIN_STEPS} from its checkpoint")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
              for m in hist), f"{cfg.name}: a loss or gradient norm is not finite and nonzero")
    module, opt_state = state.model, state.opt_state
    step_fn, _ = make_train_step(_lm_loss_fn, tcfg)
    b = _lm_batch(cfg, batch, seq, device, seed=2)
    _timed_steps(step_fn, module, opt_state, b, device, LMTRAIN_WARM)
    _reset_peak(device)
    times, m, opt_state = _timed_steps(step_fn, module, opt_state, b, device, LMTRAIN_TIMED)
    peak = _peak(device)
    step_ms = float(np.median(times))
    flops = lm_train_flops(cfg, n_params, batch, seq)
    mfu = flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS
    print(f"[times] lmtrain {cfg.name} step ({batch} x {seq} tokens, AdamW, host clock, median "
          f"of {LMTRAIN_TIMED} after {LMTRAIN_WARM} warm): {step_ms:.2f} ms "
          f"[{min(times):.2f}, {max(times):.2f}], {batch * seq / step_ms * 1e3:.0f} tokens/s; "
          f"peak memory {peak / 2**30:.2f} GiB ({n_params:,} f32 parameters, "
          f"{n_params * 16 / 2**30:.2f} GiB with gradients and two moments); model flops "
          f"{flops / 1e12:.2f} TFLOP a step (6 N a token + attention), "
          f"{flops / (step_ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * mfu:.2f}% of the "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16 peak; loss {float(m['loss']):.4f}")
    wall, events, busy = _profiled_step(
        lambda: float(step_fn(module, opt_state, b)[1]["loss"]), device)
    idle = _print_profile(f"lmtrain {cfg.name} step", wall, events, busy, step_ms)
    del module, opt_state, state, fresh, model, b
    _free_device()
    print(f"[lmtrain] {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "peak_gib": peak / 2**30, "busy_ms": busy, "idle": idle,
            "mfu": mfu}


def phase_flash_backward(device, shape=(2, 2048, 14, 2, 64), chunk: int = 1024):
    """The flash backward at qwen2-0.5b's attention shape (B, T, heads, KV
    heads, hd) on 2 x 2 tiles, f32 and bf16: dq, dk, dv against autograd
    through `full_attention` on the same inputs and output gradient, at the
    loose tier of the dtype; the peak memory of each route."""
    import torch
    from repro_torch.models.attention import blockwise_attention, full_attention

    B, T, H, KV, hd = shape
    g = torch.Generator(device=device).manual_seed(7)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(s, generator=g, device=device).to(dt)
                       for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd), (B, T, H, hd)))
        out = {}
        for name, attend in (("flash", lambda *a: blockwise_attention(
                *a, causal=True, q_chunk=chunk, kv_chunk=chunk)),
                             ("full", lambda *a: full_attention(*a, causal=True))):
            ins = [a.clone().requires_grad_(True) for a in (q, k, v)]
            _sync(device)
            base = _allocated(device)
            _reset_peak(device)
            attend(*ins).backward(do)
            _sync(device)
            out[name] = ([a.grad for a in ins], _peak(device) - base)
            del ins
        tol = TIERS[dtype][2]
        rels = [rel_err(a.float(), b.float())[1] for a, b in zip(out["flash"][0], out["full"][0])]
        ok = max(rels) <= tol
        print(f"[lmtrain] flash backward {dtype} [{B}, {T}, {H} heads, {KV} KV, hd {hd}], "
              f"{T // chunk} x {T // chunk} tiles: dq, dk, dv vs autograd through full "
              f"attention rel {rels[0]:.3e}, {rels[1]:.3e}, {rels[2]:.3e} (tol {tol}) "
              f"{'ok' if ok else 'FAIL'}; peak memory above the inputs: flash "
              f"{out['flash'][1] / 2**20:.1f} MiB, full {out['full'][1] / 2**20:.1f} MiB")
        check(ok, f"the flash backward ({dtype}) differs from autograd through full attention")
        del out, q, k, v, do
    _free_device()


def scan_backward_ms(device, scan: str, cfg, params, tokens):
    """The training route's backward (the plain chunked scan's gradients)
    on layer 0's scan inputs of ``tokens`` in the model's dtypes, with a
    seeded gradient of the output -> (device busy ms of one call, from a
    profile of it alone; host ms of a synchronized call, median of 3)."""
    import torch
    from repro_torch.kernels import mamba2

    wkv6 = _kernel_module("wkv6")
    from repro_torch.models import ssm, transformer
    from repro_torch.models.layers import norm_apply

    with torch.no_grad():
        h = transformer._embed_tokens(params, cfg, tokens)
        if scan == "wkv6":
            p0 = params["layers"][0]
            hn = norm_apply(p0["ln1"], h, "layernorm")
            r, k, v, w, _ = ssm.rwkv6_projections(p0["tm"], hn, cfg, ssm._shift(hn))
            ins, fn = (r, k, v, w, p0["tm"]["u"]), wkv6.wkv6_chunked
        else:
            p0 = params["mamba"][0]
            ins = ssm.mamba2_scan_inputs(p0["m"], norm_apply(p0["ln"], h, cfg.norm), cfg)[2]
            fn = mamba2.mamba2_ssd_chunked
        ins = [a.detach() for a in ins]
        T = tokens.shape[1]
        out = fn(*ins, chunk=min(64, T))
        do = torch.randn(out.shape, device=device,
                         generator=torch.Generator(device=device).manual_seed(9))

    def call():
        return wkv6._plain_backward(fn, ins, [True] * len(ins), (do, None), chunk=min(64, T))

    call()
    host = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        call()
        _sync(device)
        host.append((time.perf_counter() - t0) * 1e3)
    return _profiled_step(call, device)[2], sorted(host)[1]


def lm_train_kernel_vs_plain(device, cfg, params, batch):
    """The loss gradients of ``cfg`` (f32 compute) with the scans on their
    kernel route against the all-plain route (the chunked scans on the
    card's tensors, autograd through them) -> (loss rel, worst leaf's
    gradient error relative to its norm, kernel launches of the kernel
    route)."""
    import torch
    from repro_torch.kernels import mamba2

    wkv6 = _kernel_module("wkv6")
    from repro_torch.models import ssm
    from repro_torch.models.api import LMModule

    def grads():
        module = LMModule(cfg, params)
        loss, _ = module.loss(batch)
        gs = torch.autograd.grad(loss, list(module.parameters()))
        return loss.detach(), gs

    wkv6.reset_kernel_stats()
    mamba2.reset_kernel_stats()
    lk, gk = grads()
    launches = wkv6.kernel_stats()["wkv6"] + mamba2.kernel_stats()["mamba2_ssd"]
    routes = (ssm.wkv6_hopper_grad, ssm.mamba2_ssd_hopper_grad)
    ssm.wkv6_hopper_grad, ssm.mamba2_ssd_hopper_grad = (wkv6.wkv6_chunked,
                                                        mamba2.mamba2_ssd_chunked)
    try:
        lp, gp = grads()
    finally:
        ssm.wkv6_hopper_grad, ssm.mamba2_ssd_hopper_grad = routes
    worst = max(float((a - b).norm()) / max(float(b.norm()), 1e-12) for a, b in zip(gk, gp))
    return rel_err(lk, lp)[1], worst, launches


def phase_lm_train_scan(device, model, params, scan: str, steps: int = SCAN_TRAIN_STEPS,
                        seq: int = LMTRAIN_SEQ):
    """RWKV6-3B or Zamba2-2.7B at full width and depth (weights loaded by
    the earlier phases): ``steps`` AdamW steps at 1 x ``seq`` tokens, bf16
    compute, remat on, through `make_train_step` on `LMModule`: the scan
    kernel's launches a step (a layer's forward, and again in remat's
    recompute), finite losses, the step time, a profiled step and the
    plain scan backward's share of its busy time; then at 2 layers, f32
    compute, the kernel route's gradients against the all-plain route's.
    -> (kernel launches of the training steps, the numbers)."""
    import numpy as np
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import mamba2

    wkv6 = _kernel_module("wkv6")
    from repro_torch.models.api import LMModule, count_params
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    cfg = model.cfg
    stats, reset = ((wkv6.kernel_stats, wkv6.reset_kernel_stats) if scan == "wkv6" else
                    (mamba2.kernel_stats, mamba2.reset_kernel_stats))
    n_params = count_params(cfg)
    print(f"[lmtrain] {cfg.name}: memory reckoning {n_params:,} f32 parameters x 16 B "
          f"(weights, gradients, two AdamW moments) = {n_params * 16 / 1e9:.1f} GB, and 20 B at "
          f"the step's peak (the gradients before and after the clip) = "
          f"{n_params * 20 / 1e9:.1f} GB of the card's {_card_bytes(device) / 1e9:.1f} GB: "
          + ("full depth, no cut" if n_params * 20 < _card_bytes(device) else
             "past the card (on the CPU: a rehearsal)"))
    module = LMModule(cfg, params)
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps)
    step_fn, opt = make_train_step(_lm_loss_fn, tcfg)
    opt_state = opt.init(dict(module.named_parameters()))
    b = _lm_batch(cfg, 1, seq, device)
    _reset_peak(device)
    reset()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        opt_state, m = step_fn(module, opt_state, b)
        losses.append(float(m["loss"]))
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            per_step = stats()[scan]
        print(f"[lmtrain] {cfg.name} step {i + 1} loss {losses[-1]:.4f} grad_norm "
              f"{float(m['grad_norm']):.4f} ({times[-1]:.1f} ms)")
    launches = stats()[scan]
    n_scan = cfg.n_layers
    cuda = device.type == "cuda"
    check(not cuda or (per_step == 2 * n_scan and launches == steps * 2 * n_scan),
          f"{cfg.name}: {per_step} {scan} launches in a training step, not {2 * n_scan} "
          f"(one a layer in the forward and one in remat's recompute)")
    check(all(np.isfinite(losses)), f"{cfg.name}: a training loss is not finite")
    peak = _peak(device)
    step_ms = float(np.median(times[1:]))
    print(f"[times] lmtrain {cfg.name} step (1 x {seq} tokens, AdamW, host clock, median of "
          f"{steps - 1} after 1): {step_ms:.2f} ms; {scan} launches {per_step} a step "
          f"({n_scan} in the forward, {n_scan} in remat's recompute); peak memory "
          f"{peak / 2**30:.2f} GiB")
    wall, events, busy = _profiled_step(
        lambda: float(step_fn(module, opt_state, b)[1]["loss"]), device)
    bwd_ms, bwd_host_ms = scan_backward_ms(device, scan, cfg, module.tree(), b["tokens"])
    share = n_scan * bwd_ms / busy if busy > 0 and bwd_ms > 0 else None
    idle = _print_profile(
        f"lmtrain {cfg.name} step", wall, events, busy, step_ms,
        f"; the plain scan backward (layer 0's, alone: {bwd_ms:.2f} ms device busy, "
        f"{bwd_host_ms:.2f} ms host clock) x {n_scan} layers: " + (
            f"{n_scan * bwd_ms:.1f} ms, {100 * share:.1f}% of busy, and "
            f"{100 * n_scan * bwd_host_ms / step_ms:.1f}% of the step's host time"
            if share is not None else "not measured (the profiler saw no device time)"))
    del module, opt_state, m
    _free_device()
    # 2 layers (Zamba2: one stage of 2 Mamba-2 layers and the shared
    # block), f32 compute: the kernel route's gradients against the plain's
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32", remat=False)
    sub = dict(params, layers=params["layers"][:2]) if scan == "wkv6" else \
        dict(params, mamba=params["mamba"][:2])
    if scan != "wkv6":
        small = dataclasses.replace(small, attn_every=2)
    rel_l, worst, n_k = lm_train_kernel_vs_plain(device, small, sub, b)
    ok = rel_l <= F32_IDENTITY_TOL and worst <= F32_LOOSE_TOL
    print(f"[lmtrain] {cfg.name} at 2 layers, float32 compute, 1 x {seq} tokens: kernel route "
          f"({n_k} {scan} launches) vs all-plain route: loss rel {rel_l:.3e} (tol "
          f"{F32_IDENTITY_TOL}), worst gradient leaf rel {worst:.3e} of its norm (tol "
          f"{F32_LOOSE_TOL}) {'ok' if ok else 'FAIL'}")
    check((n_k == 2 or not cuda) and ok,
          f"{cfg.name}: the kernel route's gradients differ from the plain route's")
    _free_device()
    print(f"[lmtrain] {cfg.name} phase {time.perf_counter() - t_phase:.1f} s")
    return launches, {"step_ms": step_ms, "busy_ms": busy, "idle": idle,
                      "backward_share": share, "peak_gib": peak / 2**30}


# --------------------------------------------------------------------------
# [dist]: distribution on one card (a world of one NCCL rank)
# --------------------------------------------------------------------------

DIST_ATOMS = 32
DIST_CHAIN_ROWS = 8192
DIST_LM_LAYERS = 4
DIST_LM_SEQ = 2048
DIST_LM_STEPS = 6


def phase_dist(device, lm_layers: int = DIST_LM_LAYERS, seq: int = DIST_LM_SEQ,
               atoms: int = DIST_ATOMS, chain_rows: int = DIST_CHAIN_ROWS,
               pair_rows: int = 640 * 128, lm_cfg=None, lm_steps: int = DIST_LM_STEPS) -> dict:
    """A world-size-1 NCCL process group through a FileStore in a temporary
    directory (no network; a failed init fails the run), then on
    `make_host_mesh(1, 1)`:

    * full-width `gaunt_mace_ff` with ``shard_data=True`` on the registered
      activation mesh: energy and forces of a ``atoms``-atom cluster equal
      the unsharded model's at the f32 tiers;
    * `plan_chain(backend='fused_hopper', shard_spec=ShardSpec(mesh))` at
      the served bucket's ``chain_rows`` rows equal to the unsharded kernel
      call, forward and gradient, its `gaunt_chain` launches counted; a
      pinned `fused_hopper` pairwise `plan_batch` bucket of ``pair_rows``
      rows at (6, 6, 6), sharded against unsharded, its `gaunt_pair`
      launches counted;
    * RWKV6-3B at full width, ``lm_layers`` of its layers, 1 x ``seq``
      tokens: ``lm_steps`` `train_loop` steps with ``mesh`` and
      ``shardings`` (the weights gathered layer by layer) whose losses
      equal the unsharded run's (run and freed first), its `wkv6` launches
      counted, the step times the median of steps 2 on;
    * `int8_ef_cross_pod_mean` on a (1, 1, 1) ('pod', 'data', 'model') mesh
      against the plain formula.

    The group is destroyed on the way out.  On the CPU (a rehearsal) the
    group is gloo and the kernels run their plain versions; ``lm_cfg``
    replaces RWKV6-3B's config there.  -> {"gaunt_chain", "gaunt_pair",
    "wkv6": launches} of the sharded runs."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import TrainConfig, get_config
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.core import engine
    from repro_torch.data import LMTokenPipeline, lj_dataset
    from repro_torch.distributed.collectives import int8_ef_cross_pod_mean
    from repro_torch.distributed.sharding import (batch_shardings, param_shardings,
                                                  set_activation_mesh)
    from repro_torch.kernels import gaunt_fused

    wkv6 = _kernel_module("wkv6")
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import LMModule, build_model
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.train import train_loop

    t_phase = time.perf_counter()
    card = smi_line()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        cuda = device.type == "cuda"
        if cuda:
            dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                    device_id=torch.device("cuda", torch.cuda.current_device()))
        else:
            dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            print(f"[dist] process group: backend {dist.get_backend()}, world size "
                  f"{dist.get_world_size()}, FileStore in a temporary directory; {card}")
            print("[dist] one card holds one rank: no collective between two ranks runs "
                  "here; the two-rank arithmetic is held on the CPU with gloo "
                  "(tests/test_torch_dist.py)")
            mesh = make_host_mesh(1, 1, device=device.type)
            check(mesh.device_type == device.type and tuple(mesh.mesh.shape) == (1, 1),
                  f"make_host_mesh(1, 1) gave {mesh}")
            print(f"[dist] make_host_mesh(1, 1): {mesh.device_type} mesh "
                  f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}")

            # -- the force field with shard_data --------------------------------
            cl = lj_dataset(1, n_atoms=atoms, n_species=gaunt_mace_ff.n_species, seed=11)
            sp = torch.as_tensor(cl["species"][0], device=device)
            pos = torch.as_tensor(cl["pos"][0], device=device)
            plain = MaceGaunt(gaunt_mace_ff, device=device)
            e0, f0 = plain.energy_forces(sp, pos)
            sharded = MaceGaunt(dataclasses.replace(gaunt_mace_ff, shard_data=True),
                                device=device)
            sharded.load_state_dict(plain.state_dict())
            set_activation_mesh(mesh)
            try:
                # the first three sharded calls, each alone: what a first call
                # sets up shows here, apart from the steady state below
                first = []
                for _ in range(3):
                    _sync(device)
                    t0 = time.perf_counter()
                    e1, f1 = sharded.energy_forces(sp, pos)
                    _sync(device)
                    first.append((time.perf_counter() - t0) * 1e3)
                # the 'model' group's first collective (no sharded call uses it)
                probe = torch.ones(1, device=device)
                _sync(device)
                t0 = time.perf_counter()
                dist.all_reduce(probe, group=mesh.get_group("model"))
                _sync(device)
                first_model_ms = (time.perf_counter() - t0) * 1e3
                print(f"[dist] first sharded force-field calls "
                      f"{', '.join(f'{t:.1f}' for t in first)} ms (host clock, each alone); "
                      f"the 'model' group's first all_reduce {first_model_ms:.1f} ms, {card}")
                # warm, then in turns: unsharded, sharded, sharded, unsharded
                times = {"sharded": [], "unsharded": []}
                for tag in ("unsharded", "sharded", "sharded", "unsharded") * 3:
                    m = sharded if tag == "sharded" else plain
                    _sync(device)
                    t0 = time.perf_counter()
                    m.energy_forces(sp, pos)
                    _sync(device)
                    times[tag].append((time.perf_counter() - t0) * 1e3)
            finally:
                set_activation_mesh(None)
            t_sh, t_pl = (float(np.median(times[k])) for k in ("sharded", "unsharded"))
            _, e_rel = rel_err(e1.reshape(1), e0.reshape(1))
            f_err, _ = rel_err(f1, f0)
            f_tol = F32_LOOSE_TOL * max(float(f0.abs().max()), 1e-30)
            ok = (e_rel <= F32_IDENTITY_TOL and f_err <= f_tol
                  and bool(torch.isfinite(f1).all()))
            print(f"[dist] gaunt_mace_ff full width, {atoms} atoms, shard_data=True vs False: "
                  f"energy {float(e1):.6f} vs {float(e0):.6f} rel {e_rel:.3e} (tol "
                  f"{F32_IDENTITY_TOL}), forces max abs err {f_err:.3e} (tol {f_tol:.3e}) "
                  f"{'ok' if ok else 'FAIL'}; energy+forces {t_sh:.2f} ms sharded, "
                  f"{t_pl:.2f} ms unsharded (host clock, median of 6 in turns after a "
                  f"warm call each), {card}")
            check(ok, "the sharded force field disagrees with the unsharded one")
            del plain, sharded

            # -- the chain kernel on each rank's rows ------------------------------
            gen = torch.Generator(device=device).manual_seed(3)
            x = torch.randn(chain_rows, 9, device=device, generator=gen)
            w = torch.randn(chain_rows, 3, device=device, generator=gen)
            cot = torch.randn(chain_rows, 9, device=device, generator=gen)
            spec = engine.ShardSpec(mesh)
            outs = {}
            for tag, sh in (("unsharded", None), ("sharded", spec)):
                cp = engine.plan_chain((2, 2, 2), 2, backend="fused_hopper", shard_spec=sh,
                                       device=device)
                xg = x.clone().requires_grad_(True)
                if tag == "sharded":
                    gaunt_fused.reset_kernel_stats()
                y = cp.apply([xg, xg, xg], weights=[w, w, w])
                (gx,) = torch.autograd.grad((y * cot).sum(), xg)
                _sync(device)
                if tag == "sharded":
                    launches["gaunt_chain"] = gaunt_fused.kernel_stats()["gaunt_chain"]
                outs[tag] = (y.detach(), gx)
                outs[tag + "_ms"] = (event_ms(lambda: cp.apply([x, x, x], weights=[w, w, w]),
                                              reps=20) if cuda else float("nan"))
            y_err, y_rel = rel_err(outs["sharded"][0], outs["unsharded"][0])
            g_err, g_rel = rel_err(outs["sharded"][1], outs["unsharded"][1])
            ok = y_rel <= F32_IDENTITY_TOL and g_rel <= F32_LOOSE_TOL \
                and (launches["gaunt_chain"] > 0 or not cuda)
            print(f"[dist] plan_chain(backend='fused_hopper', shard_spec) at {chain_rows} rows "
                  f"vs the unsharded kernel call: out rel {y_rel:.3e}, grad rel {g_rel:.3e}, "
                  f"gaunt_chain launches {launches['gaunt_chain']} "
                  f"{'ok' if ok else 'FAIL'}; forward {outs['sharded_ms']:.3f} ms sharded, "
                  f"{outs['unsharded_ms']:.3f} ms unsharded (CUDA events, median of 20), "
                  f"{card}")
            check(ok, "the sharded chain kernel disagrees with the unsharded call, or "
                  "never launched")
            del x, w, cot, outs

            # -- the pair kernel in a pinned sharded pairwise bucket -----------------
            L = PAIR_MAIN[0]
            a1 = torch.randn(pair_rows, (L + 1) ** 2, device=device, generator=gen)
            a2 = torch.randn(pair_rows, (L + 1) ** 2, device=device, generator=gen)
            got = {}
            for tag, sh in (("unsharded", None), ("sharded", spec)):
                bp = engine.plan_batch([PAIR_MAIN], backend="fused_hopper",
                                       requires_grad=False, shard_spec=sh, device=device)
                if tag == "sharded":
                    gaunt_fused.reset_kernel_stats()
                with torch.no_grad():
                    got[tag] = bp.apply([(a1, a2)])[0]
                _sync(device)
                if tag == "sharded":
                    launches["gaunt_pair"] = gaunt_fused.kernel_stats()["gaunt_pair"]
            _, p_rel = rel_err(got["sharded"], got["unsharded"])
            ok = p_rel <= F32_IDENTITY_TOL and (launches["gaunt_pair"] > 0 or not cuda)
            print(f"[dist] plan_batch([{PAIR_MAIN}], backend='fused_hopper', shard_spec) at "
                  f"{pair_rows} rows vs the unsharded bucket: rel {p_rel:.3e}, gaunt_pair "
                  f"launches {launches['gaunt_pair']} {'ok' if ok else 'FAIL'}")
            check(ok, "the sharded pair-kernel bucket disagrees with the unsharded one, or "
                  "never launched")
            del a1, a2, got

            # -- RWKV6-3B: one sharded train_loop step ------------------------------
            cfg = dataclasses.replace(lm_cfg or get_config("rwkv6-3b"), n_layers=lm_layers)
            tcfg = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=lm_steps, log_every=1)
            res = {}
            for tag in ("unsharded", "sharded"):
                model = build_model(cfg, device=device)
                module = LMModule(cfg, model.init(torch.Generator(device=device)
                                                  .manual_seed(0)))
                pipe = LMTokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=1, seed=0)
                kw = {}
                if tag == "sharded":
                    ids = torch.empty((1, seq), dtype=torch.int32, device="meta")
                    kw = {"mesh": mesh, "shardings": {
                        "params": param_shardings(module, mesh),
                        "batch": batch_shardings({"tokens": ids, "labels": ids}, mesh)}}
                    wkv6.reset_kernel_stats()
                stamps = []  # the log hook reads each step's loss on the host
                state, hist = train_loop(lambda m, b: m.loss(b), module, pipe, tcfg,
                                         hooks={"preemption": False,
                                                "log": lambda h: stamps.append(
                                                    time.perf_counter())}, **kw)
                # each step after the first: from one logged loss to the next
                res[tag] = ([h["loss"] for h in hist],
                            float(np.median(np.diff(stamps))) * 1e3, len(stamps) - 1)
                if tag == "sharded":
                    launches["wkv6"] = wkv6.kernel_stats()["wkv6"]
                    check(type(state.opt_state["mu"][next(iter(state.opt_state["mu"]))])
                          .__name__ == "DTensor", "the sharded optimizer state is not DTensors")
                del model, module, state, hist
                _free_device()
            l_rel = max(abs(a - b) / max(1.0, abs(b))
                        for a, b in zip(res["sharded"][0], res["unsharded"][0]))
            ok = l_rel <= F32_IDENTITY_TOL and (launches["wkv6"] > 0 or not cuda)
            print(f"[dist] {cfg.name} full width, {lm_layers} of 32 layers, 1 x {seq} tokens, "
                  f"{cfg.dtype}: {lm_steps} train_loop steps with mesh and shardings, losses "
                  f"{res['sharded'][0]} vs unsharded {res['unsharded'][0]} worst rel "
                  f"{l_rel:.3e}, wkv6 launches {launches['wkv6']} {'ok' if ok else 'FAIL'}")
            print(f"[times] dist rwkv6-3b {lm_layers}-layer train_loop step (1 x {seq} "
                  f"tokens, host clock between logged losses, median of steps 2-{lm_steps}, "
                  f"{res['sharded'][2]} a side): sharded {res['sharded'][1]:.1f} ms, "
                  f"unsharded {res['unsharded'][1]:.1f} ms, {card}")
            check(ok, "the sharded RWKV6 step's loss differs from the unsharded one, or the "
                  "wkv6 kernel never launched")

            # -- the int8 error-feedback reduction -----------------------------------
            pod = init_device_mesh(device.type, (1, 1, 1),
                                   mesh_dim_names=("pod", "data", "model"))
            g = {"a": torch.randn(4096, device=device, generator=gen) * 3,
                 "b": torch.randn(64, 33, device=device, generator=gen)}
            e = {k: torch.randn_like(v) * 0.01 for k, v in g.items()}
            out, ef = int8_ef_cross_pod_mean(g, e, pod)
            worst = 0.0
            for k in g:
                xk = g[k] + e[k]
                scale = xk.abs().max().clamp_min(1e-8) / 127.0
                deq = torch.clamp(torch.round(xk / scale), -127, 127) * scale
                worst = max(worst, float((out[k] - deq).abs().max()),
                            float((ef[k] - (xk - deq)).abs().max()))
            ok = worst <= 1e-6
            print(f"[dist] int8_ef_cross_pod_mean on a (1, 1, 1) ('pod', 'data', 'model') "
                  f"mesh vs the plain formula: max abs err {worst:.3e} (tol 1e-6) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, "int8_ef_cross_pod_mean disagrees with the plain formula")
        finally:
            dist.destroy_process_group()
    print(f"[dist] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


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
    from repro_torch.config import get_config
    from repro_torch.configs.gaunt_ff import gaunt_equiformer_v2_oc20, gaunt_mace_ff

    device = torch.device("cuda")
    cfg = dataclasses.replace(gaunt_mace_ff, chain_tune="measure", grid_gate="on")
    n_slots, max_atoms = 4, 32
    rows = n_slots * max_atoms * cfg.channels
    sizes = [8, 12, 16, 20, 24, 28, 32, 32, 10, 30]
    t_start = time.perf_counter()
    pair_rows = 640 * 128
    try:
        from repro_torch.serve.pools import default_buckets

        buckets = default_buckets(max_atoms, n_slots)
        bucket_rows = [spec.n_slots * spec.max_atoms * cfg.channels for spec in buckets]
        phase_device_and_build()
        max_abs_err = phase_kernel_vs_plain(device, bucket_rows)
        pair_err = phase_pair_vs_plain(device, pair_rows)
        max_abs_err_bf16 = phase_kernel_vs_plain(device, bucket_rows, "bfloat16")
        pair_err_bf16 = phase_pair_vs_plain(device, pair_rows, "bfloat16")
        launches, model, eng = phase_main_path(device, cfg, buckets, sizes)
        phase_small_only(model, buckets)
        kernel_ms, plain_ms, bound_ms, bound_by = phase_times(device, rows)
        # the served force field again with its many-body chain stored at bf16
        cfg_bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
        launches_bf16, model_bf16, eng_bf16 = phase_main_path(device, cfg_bf16, buckets, sizes)
        (kernel_ms_bf16, plain_ms_bf16, bound_ms_bf16,
         bound_by_bf16) = phase_times(device, rows, dtype="bfloat16")
        escn_times = phase_graph_times(eng, "serve f32 chain")
        phase_graph_times(eng_bf16, "serve bf16 chain")
        step_ms = serve_step_ms(model, n_slots, max_atoms)
        step_ms_bf16 = serve_step_ms(model_bf16, n_slots, max_atoms)
        print(f"[times] serve step through the engine (4 x 32 atoms, full width, forces, "
              f"graph): f32 chain {step_ms:.2f} ms, bf16 chain {step_ms_bf16:.2f} ms host "
              f"clock, median of 5")
        profile_serve_steps(model, n_slots, max_atoms, "f32 chain")
        profile_serve_steps(model_bf16, n_slots, max_atoms, "bf16 chain")
        phase_pick_under_graph(device, model, buckets, "f32 chain")
        phase_pick_under_graph(device, model_bf16, buckets, "bf16 chain")
        phase_replicas(device, cfg, buckets)
        # free the force fields and their graphs before the larger phases
        del model, model_bf16, eng, eng_bf16
        gc.collect()
        torch.cuda.empty_cache()
        phase_autotune(device, cfg, buckets, sizes)
        phase_train(device, cfg)
        # the paper's two other models, batched plans and the measured policies
        phase_segnn(device)
        phase_selfmix(device)
        # the chain kernel at the EquiformerV2 cell's key: (6, 6) -> 6, shared
        # operand, one bucket's 86 x 16 atoms x 128 channels = 176,128 rows
        phase_selfmix(device, nodes=EQUIFORMER_BUCKET[0] * EQUIFORMER_BUCKET[1],
                      L=gaunt_equiformer_v2_oc20.L, C=gaunt_equiformer_v2_oc20.channels)
        phase_equiformer(device)
        phase_batched(device)
        phase_policies(device, buckets, sizes)
        # the paper's general convolution, the manybody plans, calibration
        general = phase_general(device, cfg, buckets, sizes, escn_times)
        direct = phase_direct_conv(device)
        phase_manybody(device)
        phase_calibrate(device)
        phase_quickstart(device)
        pair_launches, (x1, x2) = phase_pair_main(device, pair_rows)
        (pair_ms, pair_plain_ms, pair_bound_ms, pair_bound_by,
         pair_library_ms) = phase_pair_times(device, x1, x2)
        pair_launches_bf16, (x1, x2) = phase_pair_main(device, pair_rows, "bfloat16")
        (pair_ms_bf16, pair_plain_ms_bf16, pair_bound_ms_bf16, pair_bound_by_bf16,
         pair_library_ms_bf16) = phase_pair_times(device, x1, x2)
        del x1, x2
        phase_fig1a(device)
        phase_conv_filter(device)
        wkv_err = phase_wkv6_vs_plain(device)
        lm_cfg = get_config("rwkv6-3b")
        (wkv_launches, lm, lm_params, lm_tokens, wkv_in, wkv_err0) = phase_rwkv6(
            device, lm_cfg, batch=4, seq=2048, n_decode=16, check_seq=256,
            generator=torch.Generator(device=device).manual_seed(0))
        wkv_ms, wkv_plain_ms, wkv_bound_ms, wkv_bound_by = phase_wkv6_times(device, *wkv_in)
        del wkv_in
        phase_lm_times(device, "rwkv6", "wkv6", WKV6_PASSES, lm, lm_params, lm_tokens,
                       n_decode=16)
        t0 = time.perf_counter()
        lm_serve = {"rwkv6-3b": phase_lm_engine(device, lm_cfg.name, lm, lm_params)}
        print(f"[lmserve] {lm_cfg.name} phase {time.perf_counter() - t0:.1f} s")
        # training through the WKV6 kernel while the weights are loaded
        wkv_train_launches, lm_train = phase_lm_train_scan(device, lm, lm_params, "wkv6")
        lm_train = {"rwkv6-3b": lm_train}
        # free the RWKV6 parameters (12.4 GB) before the Zamba2 phases
        del lm, lm_params, lm_tokens
        torch.cuda.empty_cache()
        ssd_err = phase_mamba2_vs_plain(device)
        (ssd_launches, zm, zm_params, zm_tokens, ssd_in, ssd_err0) = phase_zamba2(
            device, get_config("zamba2-2.7b"), batch=4, seq=2048, n_decode=16,
            check_seq=256, generator=torch.Generator(device=device).manual_seed(0))
        ssd_ms, ssd_plain_ms, ssd_bound_ms, ssd_bound_by = phase_mamba2_times(
            device, *ssd_in, launches=ssd_launches)
        del ssd_in
        phase_lm_times(device, "zamba2", "mamba2_ssd", SSD_PASSES, zm, zm_params, zm_tokens,
                       n_decode=16)
        t0 = time.perf_counter()
        lm_serve["zamba2-2.7b"] = phase_lm_engine(device, zm.cfg.name, zm, zm_params)
        print(f"[lmserve] {zm.cfg.name} phase {time.perf_counter() - t0:.1f} s")
        ssd_train_launches, lm_train["zamba2-2.7b"] = phase_lm_train_scan(
            device, zm, zm_params, "mamba2_ssd")
        # free the Zamba2 parameters before the attention families
        del zm, zm_params, zm_tokens
        _free_device()
        # the LM serve engine's main path, the MoE at full depth, the families
        lm_serve["qwen2-0.5b"] = phase_lm_main(device, get_config("qwen2-0.5b"))
        lm_serve["qwen2-moe-a2.7b"] = phase_lm_moe(device, get_config("qwen2-moe-a2.7b"))
        phase_lm_families(device)
        print("[lmserve] decode step per token (4 sequences, host clock), graph / eager ms: "
              + "; ".join(f"{k} {v['graph_ms']:.3f} / {v['eager_ms']:.3f}"
                          for k, v in lm_serve.items()))
        # LM training: the main path (qwen2-0.5b), the flash backward
        lm_train["qwen2-0.5b"] = phase_lm_train_main(device, get_config("qwen2-0.5b"))
        phase_flash_backward(device)
        print("[lmtrain] training step (host clock) ms / device busy ms / idle share: "
              + "; ".join(f"{k} {v['step_ms']:.2f} / {v['busy_ms']:.2f} / "
                          + (f"{v['idle']:.3f}" if v["idle"] is not None else "not measured")
                          for k, v in lm_train.items()))
        # distribution, last: a world of one NCCL rank on this card
        dist_launches = phase_dist(device)
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
        "launches": launches + dist_launches["gaunt_chain"],
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
        "launches": pair_launches + dist_launches["gaunt_pair"],
        "max_abs_err": pair_err,
        "ms": pair_ms,
        "plain_ms": pair_plain_ms,
        "bound_ms": pair_bound_ms,
        "bound_by": pair_bound_by,
        "library_ms": pair_library_ms,
    }, {
        "name": "gaunt_chain_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gaunt_chain.cu",
        "replaces": "src/repro/kernels/gaunt_fused.py:122",
        "launches": launches_bf16,
        "max_abs_err": max_abs_err_bf16,
        "ms": kernel_ms_bf16,
        "plain_ms": plain_ms_bf16,
        "bound_ms": bound_ms_bf16,
        "bound_by": bound_by_bf16,
        "library_ms": None,
    }, {
        "name": "gaunt_pair_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gaunt_pair.cu",
        "replaces": "src/repro/kernels/gaunt_fused.py:116",
        "launches": pair_launches_bf16,
        "max_abs_err": pair_err_bf16,
        "ms": pair_ms_bf16,
        "plain_ms": pair_plain_ms_bf16,
        "bound_ms": pair_bound_ms_bf16,
        "bound_by": pair_bound_by_bf16,
        "library_ms": pair_library_ms_bf16,
    }, {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:91",
        "launches": wkv_launches + wkv_train_launches + dist_launches["wkv6"],
        "max_abs_err": max(wkv_err, wkv_err0),
        "ms": wkv_ms,
        "plain_ms": wkv_plain_ms,
        "bound_ms": wkv_bound_ms,
        "bound_by": wkv_bound_by,
        "library_ms": None,
    }, {
        "name": "mamba2_ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2.py:86",
        "launches": ssd_launches + ssd_train_launches,
        "max_abs_err": max(ssd_err, ssd_err0),
        "ms": ssd_ms,
        "plain_ms": ssd_plain_ms,
        "bound_ms": ssd_bound_ms,
        "bound_by": ssd_bound_by,
        "library_ms": None,
    }, {
        "name": "direct_conv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/direct_conv.cu",
        "replaces": None,
        "launches": general["direct_conv"] + general["direct_conv_adjoint"],
        **direct,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
