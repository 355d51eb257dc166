"""Training launcher for the language models, the port's twin of the
single-card part of the reference's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 1000 --ckpt /data/run1 [--supervise]

Wires together: the arch config, its parameters as an `LMModule` (random,
from ``--seed``), the resumable token pipeline, `train_loop` (AdamW and
cosine, global-norm clip, gradient accumulation over ``--microbatch``
pieces, async checkpoints, heartbeat, SIGTERM checkpoint, straggler
monitor) and, with ``--supervise``, restarts of the worker from the latest
checkpoint with backoff.  Runs on the GPU; ``--device cpu`` runs on the
host.  A mesh of more than one device is the reference's sharded path,
not ported yet (ROADMAP Queue 1 item 10).
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

    if args.mesh_data * args.mesh_model > 1:
        raise NotImplementedError(
            f"a mesh of {args.mesh_data} x {args.mesh_model} devices: sharded training "
            "is not ported yet (ROADMAP Queue 1 item 10); this launcher trains on one device")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    module = LMModule(cfg, model.init(torch.Generator(device=device).manual_seed(args.seed)))
    print(f"[train] arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M device={device}")

    pipe = LMTokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                           seed=args.seed)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
                       checkpoint_every=args.ckpt_every, microbatch=args.microbatch,
                       log_every=args.log_every)
    hooks = {"log": lambda m: print(f"[train] step {m['step']} loss {m['loss']:.4f}")}
    if args.ckpt:
        hooks["heartbeat_path"] = os.path.join(args.ckpt, "heartbeat.json")
    state, hist = train_loop(lambda m, b: m.loss(b), module, pipe, tcfg,
                             ckpt_dir=args.ckpt or None, hooks=hooks)
    if hist:
        print(f"[train] done at step {state.step}; loss {hist[-1]['loss']:.4f}")
    return hist


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
