"""The reference's public surface in the port, and twins of the names that
came last.

`test_port_has_every_public_name` walks every ``src/repro/**/*.py`` by AST:
its top-level public definitions (functions, classes, assigned names) and,
for a package ``__init__.py``, its re-exports.  The port's counterpart
module (``repro.X`` -> ``repro_torch.X``) must have each of them, under the
same name or under the port's rename rule (``*_pallas`` -> ``*_hopper``;
``*_xla``, ``*_jnp``, ``*_jax`` -> ``*_torch``).  The only exceptions are
`NOT_PORTED`, one line of reason each.

The twins hold each name added for this against the reference at the f32
identity tier (3e-4, scale-relative) through `tests/_torch_parity.py`;
`gate_apply` also at the bf16 identity tier (5e-2), and `gaunt_oracle` at
f64 (1e-10) against the reference run with x64 in a subprocess.
"""
import ast
import dataclasses
import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import compare, reference_x64, same_inputs

import repro.configs as jconfigs
import repro.core as jcore
import repro.kernels as jkernels
import repro.models as jmodels
from repro.config import SHAPES as JSHAPES
from repro.config import get_config as jget_config
from repro.core import cg as jcg
from repro.core import engine as jengine
from repro.core import fourier as jfourier
from repro.core.rep import Rep as JRep
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro.models import equivariant as jequivariant
import repro_torch.configs as configs
import repro_torch.core as core
import repro_torch.kernels as kernels
import repro_torch.models as models
from repro_torch.config import SHAPES, get_config
from repro_torch.core import cg, constants, engine, fourier
from repro_torch.core.irreps import num_coeffs
from repro_torch.core.rep import Rep
from repro_torch.kernels import ref
from repro_torch.models import api, attention, equivariant

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
REF_ROOT = os.path.join(SRC, "repro")

# (reference module, name) -> why the port has no counterpart.  Only the
# HLO-text names of launch/dryrun.py are here: the port's dry run counts
# collectives with CommDebugMode and reads no HLO text.
NOT_PORTED = {
    ("repro.launch.dryrun", "COLLECTIVE_RE"):
        "a regex over XLA's HLO text; the port counts c10d collectives, not HLO",
    ("repro.launch.dryrun", "TYPE_RE"):
        "a regex over HLO operand types; the port reads tensor dtypes directly",
    ("repro.launch.dryrun", "BYTES"):
        "bytes per HLO element-type name; the port takes element_size() of tensors",
    ("repro.launch.dryrun", "parse_collectives"):
        "parses collectives out of HLO text; CommDebugMode records them in the port",
    ("repro.launch.dryrun", "body_multipliers_for"):
        "trip counts of HLO while-loop bodies; the port's traced step has no HLO loops",
}

RENAMES = (("_pallas", "_hopper"), ("_xla", "_torch"), ("_jnp", "_torch"), ("_jax", "_torch"))


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, SRC)[:-3].replace(os.sep, ".")
    return rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


def _ref_files() -> list:
    out = []
    for dirpath, dirs, files in os.walk(REF_ROOT):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += [os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")]
    return out


def public_names(path: str) -> list:
    """Top-level public definitions of a module file (functions, classes,
    assigned names), and for an ``__init__.py`` also its imported names."""
    tree = ast.parse(open(path).read())
    init = os.path.basename(path) == "__init__.py"
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif init and isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def port_names(name: str) -> list:
    """``name`` and its counterparts under the port's rename rule."""
    return [name] + [name[: -len(a)] + b for a, b in RENAMES if name.endswith(a)]


REF_FILES = _ref_files()


def test_the_walk_sees_the_whole_reference():
    mods = {_module_name(p) for p in REF_FILES}
    assert {"repro", "repro.models", "repro.kernels", "repro.kernels.ref",
            "repro.models.equivariant", "repro.launch.dryrun", "repro.core.fourier"} <= mods
    assert len(REF_FILES) >= 60
    assert "gate_apply" in public_names(os.path.join(REF_ROOT, "models", "equivariant.py"))
    assert {"wkv6", "gaunt_tp_fused_xla"} <= set(
        public_names(os.path.join(REF_ROOT, "kernels", "__init__.py")))


@pytest.mark.parametrize("path", REF_FILES, ids=lambda p: os.path.relpath(p, REF_ROOT))
def test_port_has_every_public_name(path):
    mod = _module_name(path)
    port = importlib.import_module("repro_torch" + mod[len("repro"):])
    missing = [n for n in public_names(path)
               if (mod, n) not in NOT_PORTED and not any(hasattr(port, c) for c in port_names(n))]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_exceptions_are_only_the_dry_runs_hlo_names():
    """Each entry names a public name of the reference that the port really
    lacks, in launch/dryrun.py, with its one line of reason."""
    dry = importlib.import_module("repro_torch.launch.dryrun")
    ref_names = public_names(os.path.join(REF_ROOT, "launch", "dryrun.py"))
    for (mod, name), why in NOT_PORTED.items():
        assert mod == "repro.launch.dryrun" and name in ref_names
        assert not any(hasattr(dry, c) for c in port_names(name))
        assert why and "\n" not in why


def test_package_reexports_are_the_ports_own_objects():
    assert models.build_model is api.build_model and models.Model is api.Model
    assert models.count_params is api.count_params and models.input_specs is api.input_specs
    from repro_torch.core.rep import conversion_stats, reset_conversion_stats
    from repro_torch.configs.gaunt_ff import (gaunt_equiformer_selfmix, gaunt_mace_ff,
                                              gaunt_segnn_nbody)
    from repro_torch.core.gaunt import expand_degree_weights, unpack_hermitian
    from repro_torch.kernels import ops

    assert core.conversion_stats is conversion_stats
    assert core.reset_conversion_stats is reset_conversion_stats
    assert (configs.gaunt_mace_ff, configs.gaunt_segnn_nbody, configs.gaunt_equiformer_selfmix) \
        == (gaunt_mace_ff, gaunt_segnn_nbody, gaunt_equiformer_selfmix)
    for n in ("gaunt_tp_fused", "gaunt_tp_fused_torch", "gaunt_tp_channel_mix", "wkv6",
              "mamba2_ssd"):
        assert getattr(kernels, n) is getattr(ops, n)
    assert engine.expand_degree_weights is expand_degree_weights
    assert fourier.unpack_hermitian is unpack_hermitian


def test_importing_the_kernels_package_loads_no_cuda_library():
    import subprocess
    import sys

    code = ("import sys, repro_torch.kernels, repro_torch.models, repro_torch.core, "
            "repro_torch.configs\n"
            "from repro_torch.kernels import build\n"
            "print('LOADED', sorted(build._LOADED),"
            " [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED [] []" in out.stdout, out.stdout


# --------------------------------------------------------------------------
# twins of the names that came last, at the f32 identity tier
# --------------------------------------------------------------------------

def test_configs_reexports_match_reference():
    for n in ("gaunt_mace_ff", "gaunt_segnn_nbody", "gaunt_equiformer_selfmix"):
        assert dataclasses.asdict(getattr(configs, n)) == \
            dataclasses.asdict(getattr(jconfigs, n)), n


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b", "whisper-base"])
def test_models_reexports_match_reference(arch):
    """count_params, build_model and input_specs through the package names:
    the same counts and step shapes (ids int64 in the port, int32 in the
    reference)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert models.count_params(cfg) == jmodels.count_params(jcfg)
    small = cfg.reduced()
    assert isinstance(models.build_model(small, device="cpu"), models.Model)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        got = models.input_specs(small, SHAPES[shape])
        want = jmodels.input_specs(jcfg.reduced(), JSHAPES[shape])
        g = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: tuple(t.shape), got,
                         is_leaf=lambda t: isinstance(t, torch.Tensor)),
            is_leaf=lambda t: isinstance(t, tuple))[0]
        w = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda s: tuple(s.shape), want), is_leaf=lambda t: isinstance(t, tuple))[0]
        assert [(jax.tree_util.keystr(p), s) for p, s in g] == \
            [(jax.tree_util.keystr(p), s) for p, s in w], shape


def test_conversion_stats_reexports_count_as_the_reference():
    """One SH -> Fourier -> SH round trip, eager, after a reset: the same
    counters in both."""
    x = same_inputs(0, [(3, num_coeffs(2))])[0]
    core.reset_conversion_stats()
    jcore.reset_conversion_stats()
    compare(lambda a: JRep.from_sh(a, 2).to_fourier().to_sh(2).data,
            lambda a: Rep.from_sh(a, 2).to_fourier().to_sh(2).data, [x])
    got, want = dict(core.conversion_stats()), dict(jcore.conversion_stats())
    assert got["sh_to_fourier"] == want["sh_to_fourier"] == 1
    assert got["fourier_to_sh"] == want["fourier_to_sh"] == 1
    assert {k: got[k] for k in want} == want


def _pair_inputs(seed, L1, L2, rows=6):
    return same_inputs(seed, [(rows, num_coeffs(L1)), (rows, num_coeffs(L2))])


@pytest.mark.parametrize("Ls", [(1, 1, 2), (2, 2, 4), (3, 2, 3)])
def test_kernels_gaunt_tp_fused_matches_reference(Ls):
    """The package's gaunt_tp_fused (the pair kernel's plain version on CPU
    tensors) and gaunt_tp_fused_torch against the reference's
    gaunt_tp_fused (Pallas, interpreted on the CPU) and gaunt_tp_fused_xla."""
    L1, L2, Lout = Ls
    ins = _pair_inputs(1, L1, L2)
    compare(lambda a, b: jkernels.gaunt_tp_fused(a, b, L1, L2, Lout),
            lambda a, b: kernels.gaunt_tp_fused(a, b, L1, L2, Lout, device="cpu"), ins)
    compare(lambda a, b: jkernels.gaunt_tp_fused_xla(a, b, L1, L2, Lout),
            lambda a, b: kernels.gaunt_tp_fused_torch(a, b, L1, L2, Lout, device="cpu"), ins)


def test_kernels_channel_mix_matches_reference():
    L1, L2, Lout = 2, 1, 3
    x1, x2, w = same_inputs(2, [(4, 3, num_coeffs(L1)), (4, 2, num_coeffs(L2)), (3, 2, 5)])
    compare(lambda a, b, c: jkernels.gaunt_tp_channel_mix(a, b, c, L1, L2, Lout),
            lambda a, b, c: kernels.gaunt_tp_channel_mix(a, b, c, L1, L2, Lout, device="cpu"),
            [x1, x2, w])


def test_kernels_scans_match_reference():
    """The package's wkv6 and mamba2_ssd (the plain chunked scans on CPU
    tensors) against the reference's, on data whose decay stays in (0, 1).
    The reference's wrappers are read from its ``kernels.ops``: its package
    name ``wkv6`` turns into the submodule once that is first imported."""
    B, T, H, K = 2, 48, 2, 8
    r, k, v, w0, u = same_inputs(3, [(B, T, H, K)] * 4 + [(H, K)])
    w = np.exp(-np.exp(0.5 * w0)).astype(np.float32)
    compare(lambda *a: jops.wkv6(*a, chunk=16), lambda *a: kernels.wkv6(*a, chunk=16),
            [r, k, v, w, u])
    P, G, N = 4, 1, 8
    x, dt0, A0, Bm, Cm, D = same_inputs(4, [(B, T, H, P), (B, T, H), (H,), (B, T, G, N),
                                            (B, T, G, N), (H,)])
    dt = np.log1p(np.exp(dt0)).astype(np.float32) * 0.5
    A = -np.exp(A0).astype(np.float32)
    compare(lambda *a: jops.mamba2_ssd(*a, chunk=16),
            lambda *a: kernels.mamba2_ssd(*a, chunk=16), [x, dt, A, Bm, Cm, D])


@pytest.mark.parametrize("Ls", [(1, 1, 2), (2, 2, 4), (2, 3, 3)])
def test_ref_gaunt_fused_ref_matches_reference(Ls):
    """The unfused sample-multiply-project on the port's own sample and
    projection matrices (the kernel's constants, unpadded)."""
    L1, L2, Lout = Ls
    T1, T2, P = (np.asarray(m, np.float32) for m in constants.fused_matrices(L1, L2, Lout)[:3])
    x1, x2 = _pair_inputs(5, L1, L2)
    got, _ = compare(jref.gaunt_fused_ref, ref.gaunt_fused_ref, [x1, x2, T1, T2, P])
    # and it is the Gaunt product
    want = jref.gaunt_oracle(jnp.asarray(x1), jnp.asarray(x2), L1, L2, Lout)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=3e-4 * max(
        1.0, float(np.abs(np.asarray(want)).max())))


@pytest.mark.parametrize("Ls", [(1, 1, 2), (2, 2, 4), (3, 1, 2)])
def test_ref_gaunt_oracle_matches_reference(Ls):
    L1, L2, Lout = Ls
    compare(lambda a, b: jref.gaunt_oracle(a, b, L1, L2, Lout),
            lambda a, b: ref.gaunt_oracle(a, b, L1, L2, Lout), _pair_inputs(6, L1, L2))


def test_ref_gaunt_oracle_f64_matches_reference_x64():
    """The f64 twin: the reference's gaunt_oracle under x64 in a subprocess
    against the port's in float64, at tol_for('float64') = 1e-10."""
    from repro_torch.testing import assert_close, tol_for

    cases = [(1, 1, 2), (2, 2, 4), (3, 2, 3)]
    code = f"""
import jax.numpy as jnp
from repro.kernels.ref import gaunt_oracle
rng = np.random.default_rng(7)
for i, (L1, L2, Lout) in enumerate({cases!r}):
    x1 = rng.normal(size=(5, (L1 + 1) ** 2))
    x2 = rng.normal(size=(5, (L2 + 1) ** 2))
    out = gaunt_oracle(jnp.asarray(x1), jnp.asarray(x2), L1, L2, Lout)
    assert out.dtype == jnp.float64
    emit(f"x1_{{i}}", x1); emit(f"x2_{{i}}", x2); emit(f"out_{{i}}", out)
"""
    outs = reference_x64(code)
    for i, (L1, L2, Lout) in enumerate(cases):
        got = ref.gaunt_oracle(torch.from_numpy(outs[f"x1_{i}"]),
                               torch.from_numpy(outs[f"x2_{i}"]), L1, L2, Lout)
        assert got.dtype == torch.float64
        assert_close(got, outs[f"out_{i}"], tol=tol_for("float64"))


def test_equi_linear_init_matches_reference_layout_and_mix():
    """Shape, dtype and scale (N(0, 1/c_in)) of the reference's draw, on the
    generator's device; `equi_linear` over the port's draw equals the
    reference's `equi_linear` over the same numbers."""
    L, c_in, c_out = 2, 64, 48
    w = equivariant.equi_linear_init(torch.Generator().manual_seed(0), L, c_in, c_out)
    jw = jequivariant.equi_linear_init(jax.random.PRNGKey(0), L, c_in, c_out)
    assert tuple(w.shape) == jw.shape and w.dtype == torch.float32 and w.device.type == "cpu"
    assert abs(float(w.std()) * math.sqrt(c_in) - 1) < 0.05
    assert abs(float(jnp.std(jw)) * math.sqrt(c_in) - 1) < 0.05
    x = same_inputs(8, [(5, c_in, num_coeffs(L))])[0]
    compare(lambda a, b: jequivariant.equi_linear(a, b, L),
            lambda a, b: equivariant.equi_linear(a, b, L), [w.numpy(), x])


def _gate_tree(c):
    p = equivariant.gate_init(torch.Generator().manual_seed(1), c)
    return {k: v.numpy() for k, v in p.items()}


def test_gate_init_matches_reference_layout():
    """The keys and shapes of the reference's gate (the layout
    `params_from_jax` converts), each leaf at its reference scale."""
    c, hidden = 64, 32
    p = equivariant.gate_init(torch.Generator().manual_seed(1), c)
    jp = jequivariant.gate_init(jax.random.PRNGKey(1), c)
    assert sorted(p) == sorted(jp) == ["w1", "w2"]
    for k, fan_in in (("w1", c), ("w2", hidden)):
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == torch.float32
        assert abs(float(p[k].std()) * math.sqrt(fan_in) - 1) < 0.1


@pytest.mark.parametrize("L", [1, 2, 3])
def test_gate_apply_matches_reference(L):
    C = 16
    x = same_inputs(9, [(6, C, num_coeffs(L))])[0]
    compare(lambda p, a: jequivariant.gate_apply(p, a, L),
            lambda p, a: equivariant.gate_apply(p, a, L), [_gate_tree(C), x])


@pytest.mark.parametrize("L", [1, 2])
def test_gate_apply_bf16_matches_reference(L):
    """Features and gate weights in bf16 on both sides: bf16 out, at the
    bf16 identity tier."""
    C = 16
    x = same_inputs(10, [(6, C, num_coeffs(L))])[0]
    out = equivariant.gate_apply({k: torch.from_numpy(v).bfloat16()
                                  for k, v in _gate_tree(C).items()},
                                 torch.from_numpy(x).bfloat16(), L)
    assert out.dtype == torch.bfloat16
    compare(lambda p, a: jequivariant.gate_apply(p, a, L),
            lambda p, a: equivariant.gate_apply(p, a, L), [_gate_tree(C), x], dtype="bfloat16")


def test_neg_inf_matches_reference():
    assert attention.NEG_INF == jattention.NEG_INF


@pytest.mark.parametrize("L", [1, 2, 3])
def test_engine_expand_degree_weights_matches_reference(L):
    w = same_inputs(11, [(4, 3, L + 1)])[0]
    compare(lambda a: jengine.expand_degree_weights(a, L),
            lambda a: engine.expand_degree_weights(a, L), [w])


@pytest.mark.parametrize("L", [1, 2, 4])
def test_fourier_unpack_hermitian_matches_reference(L):
    """On complex half grids, as torch tensors and as numpy arrays; and it
    inverts pack_hermitian on the grid of a real function."""
    re_, im = same_inputs(12, [(3, 2 * L + 1, L + 1)] * 2)
    Fh = (re_ + 1j * im).astype(np.complex64)
    want = np.asarray(jfourier.unpack_hermitian(jnp.asarray(Fh), L))
    got = fourier.unpack_hermitian(torch.from_numpy(Fh), L)
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)
    np.testing.assert_allclose(fourier.unpack_hermitian(Fh, L), want, rtol=0, atol=0)
    x = same_inputs(13, [(2, num_coeffs(L))])[0]
    F = Rep.from_sh(torch.from_numpy(x), L).to_fourier("dense").data
    np.testing.assert_allclose(fourier.unpack_hermitian(fourier.pack_hermitian(F, L), L).numpy(),
                               F.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("Ls", [(1, 1, 2), (2, 2, 4), (3, 2, 2)])
def test_cg_gaunt_dense_tensor_torch_matches_reference(Ls):
    for dt in ("float32", "float64"):
        got = cg.gaunt_dense_tensor_torch(*Ls, dt)
        want = jcg.gaunt_dense_tensor_jnp(*Ls, dt)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
