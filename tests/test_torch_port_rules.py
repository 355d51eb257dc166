"""Rules of the port: it imports neither JAX nor the reference package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.config import get_config
from repro_torch.configs.gaunt_ff import gaunt_mace_ff
from repro_torch.device import resolve_device
from repro_torch.core.engine import plan
from repro_torch.core.gaunt import GauntTensorProduct
from repro_torch.kernels.gaunt_fused import gaunt_chain_fused_hopper, gaunt_fused_hopper
from repro_torch.kernels.mamba2 import mamba2_ssd_hopper
from repro_torch.kernels.ops import gaunt_tp_fused
from repro_torch.kernels.wkv6 import wkv6_hopper
from repro_torch.models.api import build_model
from repro_torch.models.equivariant import MaceGaunt

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def test_port_imports_no_jax_and_no_reference():
    mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
    assert "repro_torch.kernels.gaunt_fused" in mods and "repro_torch.serve.engine" in mods
    assert {"repro_torch.core.cg", "repro_torch.core.engine", "repro_torch.core.so3",
            "repro_torch.kernels.ops", "repro_torch.kernels.build"} <= set(mods)
    assert {"repro_torch.config", "repro_torch.configs.rwkv6_3b", "repro_torch.models.layers",
            "repro_torch.models.ssm", "repro_torch.models.transformer",
            "repro_torch.models.api", "repro_torch.models.convert",
            "repro_torch.kernels.ref", "repro_torch.kernels.wkv6"} <= set(mods)
    assert {"repro_torch.configs.zamba2_2p7b", "repro_torch.kernels.mamba2",
            "repro_torch.models.attention", "repro_torch.models.flash"} <= set(mods)
    assert {"repro_torch.serve.faults", "repro_torch.serve.scheduler",
            "repro_torch.serve.metrics", "repro_torch.serve.pools",
            "repro_torch.serve.replicas",
            "repro_torch.distributed.fault_tolerance"} <= set(mods)
    assert {"repro_torch.core.autotune_cache", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedules", "repro_torch.checkpoint.manager",
            "repro_torch.train.loop", "repro_torch.data.pipeline", "repro_torch.data.nbody",
            "repro_torch.examples.train_force_field"} <= set(mods)
    assert {"repro_torch.testing", "repro_torch.testing.precision",
            "repro_torch.testing.oracles", "repro_torch.examples.quickstart"} <= set(mods)
    assert {"repro_torch.models.moe", "repro_torch.launch.serve",
            "repro_torch.examples.serve_lm", "repro_torch.configs.qwen2_0p5b",
            "repro_torch.configs.whisper_base"} <= set(mods)
    assert {"repro_torch.launch.train", "repro_torch.examples.train_lm"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def test_default_device_is_cuda():
    small = dataclasses.replace(gaunt_mace_ff, channels=2, n_layers=1)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert MaceGaunt(small).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MaceGaunt(small)
    assert MaceGaunt(small, device="cpu").device.type == "cpu"


def test_pairwise_entry_points_default_to_cuda():
    x = torch.randn(3, 9)
    if torch.cuda.is_available():
        assert plan(2, 2, 4).key.device == "cuda"
        assert GauntTensorProduct(2, 2, 4).plan.key.device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plan(2, 2, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GauntTensorProduct(2, 2, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gaunt_tp_fused(x, x, 2, 2)
    assert plan(2, 2, 4, device="cpu").key.device == "cpu"
    assert gaunt_tp_fused(x, x, 2, 2, device="cpu").shape == (3, 25)


def test_other_models_and_batched_plans_default_to_cuda():
    """SegnnNBody, SelfmixLayer and plan_batch run on CUDA unless given
    device='cpu', as every entry point of the port does."""
    from repro_torch.configs.gaunt_ff import gaunt_segnn_nbody
    from repro_torch.core.engine import plan_batch
    from repro_torch.models.equivariant import SegnnNBody, SelfmixLayer

    small = dataclasses.replace(gaunt_segnn_nbody, channels=2, n_layers=1)
    makers = (lambda **kw: SegnnNBody(small, **kw), lambda **kw: SelfmixLayer(1, 2, **kw),
              lambda **kw: plan_batch([(1, 1, 2)], **kw))
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        make(device="cpu")
    assert SegnnNBody(small, device="cpu").device.type == "cpu"


def test_kernel_wrapper_runs_plain_version_only_for_cpu_tensors():
    x = torch.randn(3, 9)
    out = gaunt_chain_fused_hopper([x, x, x], (2, 2, 2), 2)
    assert out.shape == (3, 9) and out.device.type == "cpu"
    with pytest.raises(ValueError):
        gaunt_chain_fused_hopper([x.to("meta")] * 3, (2, 2, 2), 2)


def test_pair_kernel_wrapper_runs_plain_version_only_for_cpu_tensors():
    x = torch.randn(3, 9)
    out = gaunt_fused_hopper(x, x, 2, 2)
    assert out.shape == (3, 25) and out.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA device"):
        gaunt_fused_hopper(x.to("meta"), x.to("meta"), 2, 2)
    # off the CPU the route is the kernel, which has no gradient
    with pytest.raises(RuntimeError, match="no gradient"):
        gaunt_fused_hopper(x.to("meta").requires_grad_(True), x.to("meta"), 2, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        gaunt_fused_hopper(x.to("meta").requires_grad_(True), x.to("meta"), 2, 2)


def test_training_entry_points_default_to_cuda(tmp_path):
    """The training example and the autotune CLI run on the card unless
    asked for the CPU; the train loop runs where the model's parameters
    are (`MaceGaunt` defaults to CUDA, above)."""
    from repro_torch.core import autotune_cache
    from repro_torch.examples import train_force_field

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_force_field.main(["--steps", "0", "--ckpt", str(tmp_path / "ck")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune_cache.main(["--cache", str(tmp_path / "at.json")])
    assert not os.path.exists(tmp_path / "at.json")


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-2.7b"])
def test_language_model_defaults_to_cuda(name):
    cfg = get_config(name).reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_wkv6_wrapper_runs_plain_version_only_for_cpu_tensors():
    x = torch.rand(1, 8, 2, 4)
    u = torch.zeros(2, 4)
    assert wkv6_hopper(x, x, x, x, u).device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA device"):
        wkv6_hopper(x.to("meta"), x, x, x, u)


def test_mamba2_wrapper_runs_plain_version_only_for_cpu_tensors():
    x, dt = torch.randn(1, 8, 2, 4), torch.rand(1, 8, 2)
    A, D, Bm = -torch.ones(2), torch.ones(2), torch.randn(1, 8, 1, 4)
    assert mamba2_ssd_hopper(x, dt, A, Bm, Bm, D).device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA device"):
        mamba2_ssd_hopper(x.to("meta"), dt, A, Bm, Bm, D)


def test_no_raise_names_the_ported_engine_items():
    """The general conv, the manybody plan kind and calibrate_fused are
    ported (ROADMAP Queue 1 items 4a-4c), and so are the attention
    families and distribution (item 10): no source of the port names those
    items any more, and the distribution modules and the dry run import no
    jax and no module of the reference."""
    import re

    root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, fn)).read()
            assert not re.search(r"item 4[abc]\b", text), fn
            assert not re.search(r"item 10\b", text), fn
    mods = ["repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
            "repro_torch.distributed.elastic", "repro_torch.distributed",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def test_no_raise_names_the_attention_families_item():
    """No NotImplementedError of `models/` names the attention families
    (the item the port once called "12d"): dense, moe, vlm, encdec, M-RoPE
    and the int8 KV cache are ported."""
    root = os.path.join(SRC, "repro_torch", "models")
    for fn in os.listdir(root):
        if fn.endswith(".py"):
            text = open(os.path.join(root, fn)).read()
            assert "NotImplementedError" not in text or "12d" not in text, fn
            assert "_NOT_PORTED" not in text and "_LATER" not in text, fn


def test_lm_serving_entry_points_default_to_cuda():
    """The LM ServeEngine runs where its model is, and the model, the serving
    launcher and the example run on the card unless given the CPU."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine

    if not torch.cuda.is_available():
        for run in (lambda: serve.main(["--requests", "1"]),
                    lambda: serve_lm.main(["--requests", "1"])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run()
    m = build_model(get_config("qwen2-0.5b").reduced(), device="cpu")
    eng = ServeEngine(m, m.init(torch.Generator().manual_seed(0)), n_slots=1, max_len=8)
    assert eng.device.type == "cpu" and not eng.use_graph
    assert all(a.device.type == "cpu" for a in eng.cache.values())
    reqs = serve.main(["--requests", "2", "--max-new", "2", "--device", "cpu"])
    assert [len(r.output) for r in reqs] == [2, 2]
    reqs = serve_lm.main(["--requests", "2", "--max-new", "2", "--device", "cpu"])
    assert [len(r.output) for r in reqs] == [2, 2]


def test_lm_training_entry_points_default_to_cuda(tmp_path):
    """The LM training launcher and example train on the card unless given
    the CPU."""
    from repro_torch.examples import train_lm
    from repro_torch.launch import train

    if not torch.cuda.is_available():
        for run in (lambda: train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"]),
                    lambda: train_lm.main(["--steps", "1", "--ckpt", str(tmp_path / "a")])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run()
    hist = train_lm.main(["--steps", "2", "--seq", "16", "--batch", "2", "--dim", "64",
                          "--layers", "1", "--vocab", "64", "--device", "cpu",
                          "--ckpt", str(tmp_path / "b")])
    assert [h["step"] for h in hist] == [1, 2]


def test_general_conv_and_quickstart_default_to_cuda():
    """EquivariantConv's general and auto methods plan on CUDA unless given
    device='cpu', and so does the quickstart; the eSCN method builds no
    plan and runs where its tensors are."""
    from repro_torch.core.conv import EquivariantConv
    from repro_torch.examples import quickstart

    if not torch.cuda.is_available():
        for make in (lambda: EquivariantConv(2, 3, 2, method="general"),
                     lambda: EquivariantConv(2, 3, 2, method="auto"),
                     lambda: quickstart.main()):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    conv = EquivariantConv(2, 3, 2, method="general", device="cpu")
    assert conv.plan.key.device == "cpu" and conv.backend == "direct"
    assert EquivariantConv(2, 3, 2).plan is None
