"""Train a small LM (reduced qwen2 family) on the synthetic Markov corpus
with the production train loop, the port's twin of the reference's
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 --dim 512

(the defaults are small; ``--dim 768 --layers 12`` gives ~100M parameters).
Runs on the GPU; ``--device cpu`` runs on the host.  A second run with the
same ``--ckpt`` resumes from its latest checkpoint.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.config import TrainConfig, get_config
from repro_torch.data import LMTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.api import LMModule, build_model
from repro_torch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "lm_ckpt_torch"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(
        d_model=args.dim, n_layers=args.layers, n_heads=max(4, args.dim // 64),
        n_kv_heads=max(2, args.dim // 128), head_dim=64, d_ff=args.dim * 4,
        vocab=args.vocab, attn_chunk=args.seq, max_seq=args.seq * 2,
    )
    model = build_model(cfg, device=device)
    module = LMModule(cfg, model.init(torch.Generator(device=device).manual_seed(0)))
    n = sum(p.numel() for p in module.parameters())
    print(f"arch={cfg.name} params={n / 1e6:.1f}M device={device}")

    pipe = LMTokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                       checkpoint_every=100, log_every=10)
    state, hist = train_loop(lambda m, b: m.loss(b), module, pipe, tcfg, ckpt_dir=args.ckpt,
                             hooks={"log": lambda m: print(
                                 f"step {m['step']:4d}  loss {m['loss']:.4f}  "
                                 f"ce {m['ce']:.4f}")})
    if hist:
        print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()
