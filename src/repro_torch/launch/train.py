"""Training launcher for the language models, the port's twin of the
reference's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 1000 --ckpt /data/run1 [--supervise]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-0.5b --mesh-data 2 --mesh-model 2 --steps 1000

Wires together: the arch config, its parameters as an `LMModule` (random,
from ``--seed``), the resumable token pipeline, `train_loop` (AdamW and
cosine, global-norm clip, gradient accumulation over ``--microbatch``
pieces, async checkpoints, heartbeat, SIGTERM checkpoint, straggler
monitor) and, with ``--supervise``, restarts of the worker from the latest
checkpoint with backoff.  Runs on the GPU; ``--device cpu`` runs on the
host.  A mesh of more than one device (``--mesh-data`` x ``--mesh-model``)
runs under ``torchrun`` with that many processes: each joins the process
group (NCCL on cuda, each on its ``LOCAL_RANK``'s card; gloo with
``--device cpu``), builds the (data, model) mesh, registers it as the
activation mesh and trains through the sharded step of `train_loop` on the
`param_shardings` and `batch_shardings` placements.  Rank 0 logs and writes
the checkpoints.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def run_once(args):
    """One training run -> the loop's history (a dict of metrics a logged
    step)."""
    import torch
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import LMTokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models.api import LMModule, build_model, count_params
    from repro_torch.train import train_loop

    n_mesh = args.mesh_data * args.mesh_model
    device = resolve_device(args.device)
    mesh = None
    if n_mesh > 1:
        mesh, device = _join_mesh(args, device)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = build_model(cfg, device=device)
        module = LMModule(cfg, model.init(torch.Generator(device=device).manual_seed(args.seed)))
        if rank0:
            print(f"[train] arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M "
                  f"device={device} mesh={(args.mesh_data, args.mesh_model)}")

        pipe = LMTokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                               seed=args.seed)
        tcfg = TrainConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
                           checkpoint_every=args.ckpt_every, microbatch=args.microbatch,
                           log_every=args.log_every)
        hooks = {"log": (lambda m: print(f"[train] step {m['step']} loss {m['loss']:.4f}"))
                 if rank0 else (lambda m: None)}
        if args.ckpt and rank0:
            hooks["heartbeat_path"] = os.path.join(args.ckpt, "heartbeat.json")
        shardings = None
        if mesh is not None:
            from repro_torch.distributed.sharding import batch_shardings, param_shardings

            ids = torch.empty((args.batch, args.seq), dtype=torch.int32, device="meta")
            shardings = {"params": param_shardings(module, mesh),
                         "batch": batch_shardings({"tokens": ids, "labels": ids}, mesh)}
        state, hist = train_loop(lambda m, b: m.loss(b), module, pipe, tcfg,
                                 ckpt_dir=args.ckpt or None, hooks=hooks, mesh=mesh,
                                 shardings=shardings)
        if hist and rank0:
            print(f"[train] done at step {state.step}; loss {hist[-1]['loss']:.4f}")
        return hist
    finally:
        if mesh is not None:
            from repro_torch.distributed.sharding import set_activation_mesh

            set_activation_mesh(None)
            torch.distributed.destroy_process_group()


def _join_mesh(args, device):
    """Join the ``torchrun`` world (NCCL on cuda, gloo on the CPU) and build
    the (data, model) mesh, registered as the activation mesh ->
    (mesh, this rank's device)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import set_activation_mesh
    from repro_torch.launch.mesh import make_host_mesh

    n_mesh = args.mesh_data * args.mesh_model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n_mesh:
        raise RuntimeError(
            f"a ({args.mesh_data}, {args.mesh_model}) mesh needs {n_mesh} processes: run "
            f"under torchrun --nproc-per-node {n_mesh} (WORLD_SIZE is {world})")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    mesh = make_host_mesh(args.mesh_data, args.mesh_model, device=device.type)
    set_activation_mesh(mesh)
    return mesh, device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--supervise", action="store_true",
                    help="restart from the latest checkpoint on failure (backoff)")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if not args.supervise:
        run_once(args)
        return 0
    # supervisor: restart the worker process on a crash; it resumes from
    # the latest checkpoint
    child = [a for a in argv if a != "--supervise"]
    backoff = 2.0
    for attempt in range(args.max_restarts + 1):
        code = subprocess.call([sys.executable, "-m", "repro_torch.launch.train", *child])
        if code == 0:
            return 0
        print(f"[supervise] worker exited {code}; restart {attempt + 1} in {backoff:.0f}s",
              file=sys.stderr)
        time.sleep(backoff)
        backoff = min(backoff * 2, 60)
    return 1


if __name__ == "__main__":
    sys.exit(main())
