"""The chain kernel at the shapes of SEGNN's resident edge product and of
the EquiformerV2 Selfmix layer, the two models with their chains pinned to
the kernel, `plan_batch` buckets on the pair kernel, the general
convolution's force field served and trained, the manybody plans,
`calibrate_fused`, the quickstart, the LM engine's decode graph against
its eager step and the LM scans' training route against the plain scans —
on the card.
Marked ``cuda``: these skip without an sm_90 GPU (on the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_models.py``)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gaunt_ff import gaunt_segnn_nbody
from repro_torch.core import engine
from repro_torch.core.constants import pair_matrices, to_torch
from repro_torch.data import nbody_dataset
from repro_torch.kernels.gaunt_fused import kernel_stats, pair_plain, reset_kernel_stats
from repro_torch.models.equivariant import SegnnNBody, SelfmixLayer

pytestmark = pytest.mark.cuda


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 GPU: the CUDA kernel has no CPU mode")
    from repro_torch.device import set_float32_policy

    set_float32_policy()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Ls,Lout,entries,B", [((1, 1), 1, ("sh", "grid"), 1),
                                               ((1, 1), 1, ("sh", "grid"), 4099),
                                               ((4, 4), 4, ("sh", "sh"), 65),
                                               ((4, 4), 4, ("sh", "sh"), 8192)])
def test_chain_kernel_model_shapes_match_plain_on_card(cuda_device, Ls, Lout, entries, B, dtype):
    """Forward and gradients against the plain version: SEGNN's grid entry
    with an SH operand that needs the gradient, and Selfmix's (4, 4) chain
    whose shared memory takes the launch past 48 KB."""
    err, rel, grel, gulp = _CS.compare_chain(Ls, Lout, entries, "sh", B, False, cuda_device,
                                             seed=3, dtype=dtype)
    if dtype == "float32":
        assert rel <= _CS.F32_IDENTITY_TOL and grel <= _CS.F32_LOOSE_TOL
    else:
        assert rel <= _CS.BF16_KERNEL_TOL and grel <= _CS.BF16_KERNEL_TOL and gulp <= 1.0


def test_segnn_kernel_pinned_equals_tree_on_card(cuda_device):
    cfg = dataclasses.replace(gaunt_segnn_nbody, channels=8, n_layers=2, chain_tune="measure")
    model = SegnnNBody(cfg, device=cuda_device)
    d = {k: torch.as_tensor(v, device=cuda_device)
         for k, v in nbody_dataset(6, horizon=50, seed=2).items()}
    eng = engine.get_engine()
    key = eng.chain_measure_key((1, 1), 1, "float32", 6 * 25 * 8, None, False, cuda_device,
                                ("sh", "fourier"), "sh")
    out = {}
    for backend in ("tree", "fused_hopper"):
        with eng.pinned_chain(key, backend):
            reset_kernel_stats()
            loss = model.loss(d)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            torch.cuda.synchronize()
            out[backend] = (float(loss.detach()), grads, kernel_stats()["gaunt_chain"])
    assert out["fused_hopper"][2] == cfg.n_layers and out["tree"][2] == 0
    assert abs(out["fused_hopper"][0] - out["tree"][0]) <= 3e-4 * max(1.0, out["tree"][0])
    assert _CS._grad_err(out["fused_hopper"][1], out["tree"][1]) <= 2e-3


def test_selfmix_kernel_pinned_one_launch_on_card(cuda_device):
    L, C = 4, 8
    layer = SelfmixLayer(L, C, tune="measure", device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(64, C, 25)),
                        dtype=torch.float32, device=cuda_device)
    eng = engine.get_engine()
    key = eng.chain_measure_key((L, L), L, "float32", 64 * C, (0, 0), False, cuda_device)
    ys = {}
    for backend in ("tree", "fused_hopper"):
        with eng.pinned_chain(key, backend), torch.no_grad():
            reset_kernel_stats()
            ys[backend] = layer(x)
            torch.cuda.synchronize()
            assert kernel_stats()["gaunt_chain"] == (backend == "fused_hopper")
    assert _CS.rel_err(ys["fused_hopper"], ys["tree"])[1] <= 3e-4


def test_plan_batch_one_pair_launch_per_bucket_on_card(cuda_device):
    items = [(6, 6, 6, 300), (4, 4, 4, 7), (6, 6, 6, 129)]
    rng = np.random.default_rng(5)
    ins = [tuple(torch.as_tensor(rng.normal(size=(n, (L + 1) ** 2)), dtype=torch.float32,
                                 device=cuda_device) for L in (L1, L2))
           for L1, L2, _, n in items]
    bp = engine.plan_batch(items, backend="fused_hopper", requires_grad=False,
                           device=cuda_device)
    reset_kernel_stats()
    outs = bp.apply(ins)
    torch.cuda.synchronize()
    assert kernel_stats()["gaunt_pair"] == len(bp.buckets) == 2
    for (L1, L2, Lout, _), (a, b), got in zip(items, ins, outs):
        # the kernel against its plain version at each bucket's shape ...
        mats = [to_torch(m, cuda_device) for m in pair_matrices(L1, L2, Lout)]
        assert _CS.rel_err(got, pair_plain(a, b, *mats))[1] <= _CS.PAIR_VS_PLAIN_TOL
        # ... and the bucketing against per-plan calls
        p = engine.plan(L1, L2, Lout, backend="fused_hopper", requires_grad=False,
                        device=cuda_device)
        assert float((got - p.apply(a, b)).abs().max()) <= 1e-6


def test_general_conv_model_served_and_trained_on_card(cuda_device):
    """`MaceGaunt(conv_impl='general')` at a small width through the bucketed
    engine on the card (each bucket's step a CUDA graph): served == direct,
    general == eSCN, rotation, chain launches through the replays, a warm
    autotune file, two training steps and kernel- vs tree-pinned loss."""
    import dataclasses

    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.serve.pools import default_buckets

    cfg = dataclasses.replace(gaunt_mace_ff, channels=8, n_species=4, chain_tune="measure",
                              grid_gate="on")
    _CS.phase_general(cuda_device, cfg, default_buckets(8, 2), [3, 5, 8], train_steps=2)


def test_manybody_kind_on_card(cuda_device):
    """Every manybody backend against the tree chain on the card, forward and
    gradients, and plan_batch's Ls buckets against per-plan calls."""
    _CS.phase_manybody(cuda_device, rows=1024)


def test_calibrate_fused_on_card(cuda_device):
    """calibrate_fused at f32 and bf16 on the card, reloaded measured from
    the autotune file with zero timing runs."""
    _CS.phase_calibrate(cuda_device, sweep=False)


def test_quickstart_on_card(cuda_device):
    """The quickstart twin on the card: every error below 1e-5, the pair
    kernel launched."""
    reset_kernel_stats()
    _CS.phase_quickstart(cuda_device)
    assert kernel_stats()["gaunt_pair"] > 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b", "rwkv6-3b"])
def test_lm_decode_graph_matches_eager(cuda_device, arch):
    """The LM engine's decode step as a CUDA graph against its eager step, at
    a reduced dense, MoE and ssm config in bf16: the same served tokens for
    every request, and from one cache the same logits and the same cache
    after the step."""
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import _leaves

    cfg = get_config(arch).reduced(dtype="bfloat16")
    model = build_model(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))

    def requests():
        return [Request(prompt=[3 + i, 5, 2, 7, 1][: 2 + i % 4], max_new_tokens=6, rid=i)
                for i in range(5)]

    graph = ServeEngine(model, params, n_slots=2, max_len=32, warmup=True)
    eager = ServeEngine(model, params, n_slots=2, max_len=32, eager=True)
    got, want = graph.run(requests()), eager.run(requests())
    assert graph.replays > 0 and eager._graph is None
    assert [r.output for r in got] == [r.output for r in want]
    for r in requests()[:2]:
        assert graph.add_request(r)
    toks = np.array([r.output[-1] for r in graph.slot_req], np.int64)
    pos = graph.pos + 1
    snap = [a.clone() for a in _leaves(graph.cache)]
    with torch.no_grad():
        lg = graph._run(graph._upload(toks[None], pos[None]), 0).clone()
        after = [a.clone() for a in _leaves(graph.cache)]
        for a, b in zip(_leaves(graph.cache), snap):
            a.copy_(b)
        le = graph.evaluate(toks, pos)
    assert torch.equal(lg, le)
    assert all(torch.equal(a, b) for a, b in zip(after, _leaves(graph.cache)))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_lm_training_kernel_route_matches_plain_on_card(cuda_device, arch):
    """`Model.loss`'s gradients at a reduced config, f32 compute, 2 x 64
    tokens: the scans on the kernel route (the kernel's forward, the plain
    scan's gradients) against the all-plain route (the chunked scans on the
    card's tensors, autograd through them), every leaf within 2e-3 of its
    norm; one kernel launch a scan layer."""
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model

    cfg = get_config(arch).reduced(dtype="float32")
    params = build_model(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    batch = _CS._lm_batch(cfg, 2, 64, cuda_device)
    rel_l, worst, launches = _CS.lm_train_kernel_vs_plain(cuda_device, cfg, params, batch)
    assert launches == cfg.n_layers
    assert rel_l <= _CS.F32_IDENTITY_TOL and worst <= _CS.F32_LOOSE_TOL, (rel_l, worst)
