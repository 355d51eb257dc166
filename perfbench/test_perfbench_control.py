"""The control on the card: the reference put in the program's place and
computed in float32 with TF32 matrix products (the precision below the
program's float32 with TF32 off) fails a cell's limits, where the program
at the same size passes them.  At a size a test run holds: one batch of
eight 27-atom molecules and training batches of 4."""
import numpy as np
import pytest
import torch

from perfbench import bench, check
from perfbench.families import mace
from perfbench.lj import lj_dataset


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mace_escn.md_3bpa", "mace_general.md_3bpa"])
def test_serve_control_fails_the_limits(card, cell):
    c = bench.cell(cell)
    cfg, lim = bench.config(c["config"]), bench.limits(cell)
    wts = mace.make_weights(cfg, 5, card)
    d = lj_dataset(8, 27, 4, seed=5)
    recs = [{"species": d["species"][i].astype(np.int64), "pos": d["pos"][i]} for i in range(8)]
    readings = check.control_serve(mace, cfg, wts, recs, card)
    assert not check.verdict(readings, lim), readings


@pytest.mark.cuda
def test_train_control_fails_the_limits(card):
    cell = "mace_escn.train_3bpa"
    c = bench.cell(cell)
    cfg, mix, lim = bench.config(c["config"]), bench.traffic(c["traffic"]), bench.limits(cell)
    w0 = mace.make_weights(cfg, 5, card)
    d = lj_dataset(12, 27, 4, seed=5)
    batches = [{k: torch.as_tensor(v[4 * i: 4 * i + 4]) for k, v in d.items()} for i in range(3)]
    from repro_torch.config import TrainConfig

    from perfbench.train import adamw_settings

    opt = adamw_settings(TrainConfig(**mix["optimizer"]))
    readings = check.control_train(mace, cfg, w0, batches, opt, mix, card)["tf32"]
    assert not check.verdict(readings, lim), readings
