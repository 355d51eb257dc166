"""The harness's check sees a broken timed path: each cell driven at CPU
size through the whole run (the look for a chip skipped), with the path
broken underneath where the answer is produced, comes out not correct; the
sound path comes out correct.  The limits are the cells' own."""
import time

import pytest
import torch

from perfbench import run

SERVE = ["mace_escn.md_3bpa", "mace_general.md_3bpa"]


def _run(cell, **kw):
    res, checks, _ = run.run_cell(cell, 2 ** 32 + 11, 0.4, False, "cpu", time.perf_counter(),
                                  **kw)
    return res, checks


@pytest.mark.parametrize("cell", SERVE + ["mace_escn.train_3bpa"])
def test_sound_path_is_correct(tiny, cell):
    res, checks = _run(cell)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0


def _broken_forward(kind):
    from repro_torch.serve.pools import SlotPool

    sound = SlotPool._forward

    def forward(self, species, pos, mask):
        e, f = sound(self, species, pos, mask)
        if kind == "answer":          # one slot's forces altered where produced
            f = torch.cat([f[:1] * 1.02, f[1:]])
        else:                         # the second half of the batch left out
            half = f.shape[0] // 2
            e = torch.cat([e[:half], torch.zeros_like(e[half:])])
            f = torch.cat([f[:half], torch.zeros_like(f[half:])])
        return e, f
    return forward


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("kind", ["answer", "half_batch"])
def test_serve_fault_is_not_correct(tiny, monkeypatch, cell, kind):
    from repro_torch.serve.pools import SlotPool

    monkeypatch.setattr(SlotPool, "_forward", _broken_forward(kind))
    res, checks = _run(cell)
    assert not res["correct"], checks


def _state_unchanged(step):
    def s(model, opt_state, batch):
        keep = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt_state, metrics = step(model, opt_state, batch)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(keep[k])
        return opt_state, metrics
    return s


def _half_batch(step):
    def s(model, opt_state, batch):
        return step(model, opt_state, {k: v[: len(v) // 2] for k, v in batch.items()})
    return s


def _loss_altered(step):
    def s(model, opt_state, batch):
        opt_state, metrics = step(model, opt_state, batch)
        return opt_state, dict(metrics, loss=metrics["loss"] * 1.01)
    return s


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _loss_altered],
                         ids=["state_unchanged", "half_batch", "answer"])
def test_train_fault_is_not_correct(tiny, fault):
    res, checks = _run("mace_escn.train_3bpa", step_factory=fault)
    assert not res["correct"], checks


def test_rejected_requests_count_as_failed(tiny, monkeypatch):
    """A request the engine rejects is a failed one: counted, and the run
    is not correct; its client goes on sending."""
    from repro_torch.serve.engine import EquivariantServeEngine

    sound = EquivariantServeEngine.validate

    def validate(self, req):
        return ("invalid", "planted") if req.rid % 3 == 0 else sound(self, req)

    monkeypatch.setattr(EquivariantServeEngine, "validate", validate)
    res, checks = _run("mace_escn.md_3bpa")
    assert res["failed"] > 0 and res["attempted"] > res["failed"]
    assert not res["correct"]
