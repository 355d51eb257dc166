"""Serving launcher: batched LM decoding over the continuous-batching engine,
the port's twin of the reference's ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --slots 4

The model is the arch's reduced config on random weights from seed 0
(``--full``: the published widths and depth).  It runs on the GPU, its
decode step a CUDA graph; ``--device cpu`` runs the eager step on the host.
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    from repro_torch.config import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.api import build_model
    from repro_torch.serve import Request, ServeEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth instead of the reduced config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, n_slots=args.slots, max_len=args.max_len, warmup=True)
    reqs = [Request(prompt=[(11 * i + j) % cfg.vocab for j in range(5)],
                    max_new_tokens=args.max_new, temperature=args.temperature, rid=i)
            for i in range(args.requests)]
    t0 = time.time()
    engine.run(reqs)
    dt = time.time() - t0
    tokens = sum(len(r.output) for r in reqs)
    print(f"[serve] {cfg.name} on {device}: {len(reqs)} requests, {tokens} tokens, "
          f"{dt:.2f}s ({tokens / dt:.1f} tok/s)")
    return reqs


if __name__ == "__main__":
    main()
