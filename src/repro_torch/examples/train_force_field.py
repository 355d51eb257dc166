"""End-to-end example (the paper's kind): train a Gaunt-MACE force field on
synthetic Lennard-Jones clusters with the full training substrate (AdamW +
cosine, checkpointing, resume), then check the trained model's rotation
invariance.  The port's twin of the reference's
``examples/train_force_field.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_force_field --steps 300

Runs on the GPU; ``--device cpu`` runs the plain path on the host.  A
second run with the same ``--ckpt`` resumes from its latest checkpoint.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.core.so3 import rotation_matrix_zyz
from repro_torch.data import lj_dataset
from repro_torch.models.equivariant import MaceGaunt
from repro_torch.train import train_loop


class LJBatches:
    """Resumable batch iterator over a fixed synthetic dataset."""

    def __init__(self, n=128, batch=16, seed=0, n_atoms=8):
        self.data = lj_dataset(n, n_atoms=n_atoms, n_species=4, seed=seed)
        self.n, self.batch, self.step = n, batch, 0

    def state(self):
        return {"step": self.step}

    def restore(self, s):
        self.step = int(s["step"])

    def next_batch(self):
        rng = np.random.default_rng((1234, self.step))
        idx = rng.choice(self.n, self.batch, replace=False)
        self.step += 1
        return {k: v[idx] for k, v in self.data.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "gaunt_mace_ckpt_torch"))
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--L", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(gaunt_mace_ff, channels=args.channels, L=args.L,
                              L_edge=2, n_layers=1, nu=2)
    model = MaceGaunt(cfg, device=args.device, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name}  params={n_params:,}  device={model.device}")

    tcfg = TrainConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                       checkpoint_every=100, log_every=10, grad_clip=10.0)

    def loss_fn(m, batch):
        loss = m.loss(batch)
        return loss, {"mse": loss.detach()}

    state, hist = train_loop(loss_fn, model, LJBatches(), tcfg, ckpt_dir=args.ckpt,
                             hooks={"log": lambda m: print(
                                 f"step {m['step']:4d}  loss {m['loss']:.4f}")})
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f}  (start {hist[0]['loss']:.4f})")
    # quick validation: energy invariance of the trained model
    d = lj_dataset(1, n_atoms=8, n_species=4, seed=99)
    R = torch.as_tensor(rotation_matrix_zyz(0.5, 1.0, -0.3), dtype=torch.float32,
                        device=model.device)
    s = torch.as_tensor(d["species"][0], device=model.device)
    pos = torch.as_tensor(d["pos"][0], device=model.device)
    with torch.no_grad():
        e1 = state.model.energy(s, pos)
        e2 = state.model.energy(s, pos @ R.T)
    print(f"rotation invariance: E={float(e1):.5f} vs {float(e2):.5f}")


if __name__ == "__main__":
    main()
