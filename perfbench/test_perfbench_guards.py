"""The harness's guarantees: it and its reference load no module of JAX or
of the JAX package ``repro`` (whole top-level names compared: the port's
``repro_torch`` begins with ``repro``), no family's reference or inputs
load anything of the port, and a run that finds no card exits non-zero and
prints no result."""
import os
import subprocess
import sys

import pytest

from perfbench import bench

ROOT = str(bench.ROOT)


def _python(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300,
                          env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env))


TOPS = "sorted({m.split('.')[0] for m in sys.modules})"


def test_harness_started_loads_no_jax():
    """Import every module of the harness and drive a cell at CPU size
    through the whole run path: no jax, jaxlib, flax or repro after."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{ROOT!r}]\n"
        "import perfbench.run, perfbench.calibrate, perfbench.serve, perfbench.train\n"
        "import perfbench.families.mace\n"
        "from perfbench import bench, run\n"
        "import json\n"
        "base_c, base_t = bench.config, bench.traffic\n"
        "def c(n):\n"
        "    d = base_c(n); d['model'] = dict(d['model'], channels=4, hidden=8,"
        " chain_tune='heuristic'); return d\n"
        "def t(n):\n"
        "    d = base_t(n); d.update(atoms=[5, 5], clients=4, buckets=[[6, 2]]); return d\n"
        "bench.config, bench.traffic = c, t\n"
        "res, checks, rec = run.run_cell('mace_escn.md_3bpa', 3, 0.3, False, 'cpu',"
        " time.perf_counter())\n"
        "print('CORRECT', res['correct'])\n"
        f"print('TOPS', {TOPS})\n"
        "print('BAD', bench.forbidden_modules())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CORRECT True" in out.stdout
    assert "BAD []" in out.stdout, out.stdout
    assert "repro_torch" in out.stdout       # the port did run


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{ROOT!r}]\n"
        "import perfbench.reference, perfbench.check, perfbench.work, perfbench.lj\n"
        "import perfbench.weights, perfbench.plain, perfbench.families.mace\n"
        f"tops = {TOPS}\n"
        "print('BAD', [t for t in tops if t in ('repro_torch', 'repro', 'jax', 'jaxlib',"
        " 'flax')])\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout


FAMILIES = sorted(p.stem for p in (bench.HERE / "families").glob("*.py")
                  if p.stem != "__init__")


@pytest.mark.parametrize("family", FAMILIES)
def test_family_reference_loads_nothing_of_the_port(family):
    """Each family's plain reference, run on its own inputs for every cell
    of a configuration that names it (one molecule, or one row of the first
    batch), loads no module of the port, of JAX or of ``repro``."""
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{ROOT!r}]\n"
        "from perfbench import bench\n"
        f"fam = bench.family({family!r})\n"
        "man = bench.manifest()\n"
        "ran = 0\n"
        "for w in man['workloads']:\n"
        "    cfg, mix = bench.config(w['config']), bench.traffic(w['traffic'])\n"
        f"    if cfg['family'] != {family!r}:\n"
        "        continue\n"
        "    wts = fam.make_weights(cfg, 3, 'cpu')\n"
        "    ref = fam.reference(cfg, wts, torch.float64, 'cpu')\n"
        "    if mix['kind'] == 'serve':\n"
        "        sp, pos = fam.molecules(mix, mix['atoms'][0], 1, 3)\n"
        "        e, f = ref.energy_forces(torch.as_tensor(sp), torch.as_tensor(pos))\n"
        "    else:\n"
        "        b = {k: torch.as_tensor(v[:1]) for k, v in fam.batches(mix, 3)(0).items()}\n"
        "        e = fam.reference_loss(ref, b, ref.params(), mix)\n"
        "    assert torch.isfinite(e).all()\n"
        "    ran += 1\n"
        f"tops = {TOPS}\n"
        "print('RAN', ran)\n"
        "print('BAD', [t for t in tops if t in ('repro_torch', 'repro', 'jax', 'jaxlib',"
        " 'flax')])\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
    assert "RAN 0" not in out.stdout


def test_forbidden_names_are_whole_top_level_names():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.serve", "jaxtyping",
                                    "reprox.a"]) == []
    assert bench.forbidden_modules(["repro.core.engine", "jaxlib.xla", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"), "--workload",
         "mace_escn.md_3bpa", "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
