"""Serve a small LM with batched requests through the continuous-batching
engine (any of the ten archs, reduced config), the port's twin of the
reference's ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen2-0.5b --requests 6

Runs on the GPU, the decode step a CUDA graph; ``--device cpu`` runs the
eager step on the host.
"""
import argparse
import time

import torch

from repro_torch.config import get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, n_slots=args.slots, max_len=128)

    reqs = [
        Request(prompt=[(7 * i + j) % cfg.vocab for j in range(4 + i % 3)],
                max_new_tokens=args.max_new, temperature=args.temperature, rid=i)
        for i in range(args.requests)
    ]
    t0 = time.time()
    engine.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.output}")
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, {args.slots} slots, arch={args.arch}, {device})")
    return reqs


if __name__ == "__main__":
    main()
