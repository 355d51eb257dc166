"""The port's S^2 quadrature — twins of tests/test_quadrature.py (exactness
at the predicted order, aliasing under oversampling, the Rep legs and their
counters, the quadrature gate) — and its matrices against the reference's
builders, bit for bit in float64 and at each storage cast.

Tolerances: float64 exactness at 1e-12 as the reference's tests; the
quadrature gate at the f32 'transform' tier, bf16 at its own tier
(``repro.testing.tol_for``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as ref_constants
from repro.core import fourier as ref_fourier
from repro.models.equivariant import _gate_quad as ref_gate_quad
from repro.testing import assert_close, random_angles, random_irreps, rotate_irreps
from repro_torch.core import constants, fourier
from repro_torch.core.engine import _gate_sh
from repro_torch.core.fourier import s2quad_exact_degree, s2quad_size
from repro_torch.core.rep import Rep, conversion_stats
from repro_torch.models.equivariant import _gate_quad


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


# --------------------------------------------------------------------------
# the matrices against the reference's builders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("L,os", [(1, 1), (1, 2), (2, 2), (4, 2)])
def test_quadrature_matrices_equal_reference(L, os):
    nt, nph = s2quad_size(L, os)
    assert (nt, nph) == ref_fourier.s2quad_size(L, os)
    assert s2quad_exact_degree(nt, nph) == ref_fourier.s2quad_exact_degree(nt, nph)
    for name in ("quad_sample_sh", "quad_project_sh", "quad_sample_fourier",
                 "quad_project_fourier"):
        got = getattr(constants, name)(L, nt, nph)
        want = getattr(ref_constants, name)(L, nt, nph)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    # the storage casts are the reference's casts of its float64 builders
    assert np.array_equal(constants.quad_sample_sh(L, nt, nph, "float32"),
                          ref_constants.quad_sample_sh(L, nt, nph).astype(np.float32))
    assert np.array_equal(
        constants.quad_project_fourier(L, nt, nph, "complex64"),
        ref_constants.quad_project_fourier(L, nt, nph).astype(np.complex64))
    bf = constants.quad_project_sh(L, nt, nph, "bfloat16")
    want = np.asarray(jnp.asarray(ref_constants.quad_project_sh(L, nt, nph))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(bf, want)


def test_grid_resize_equals_reference():
    rng = np.random.default_rng(3)
    F = (rng.normal(size=(2, 5, 5)) + 1j * rng.normal(size=(2, 5, 5))).astype(np.complex64)
    Fh = F[..., 2:]
    for fn in ("grid_resize", "grid_resize_half"):
        a = F if fn == "grid_resize" else Fh
        for to in (1, 2, 4):
            want = np.asarray(getattr(ref_fourier, fn)(jnp.asarray(a), 2, to))
            assert np.array_equal(getattr(fourier, fn)(a, 2, to), want)
            got = getattr(fourier, fn)(torch.as_tensor(a), 2, to)
            assert np.array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the quadrature rule: numpy float64 exactness
# --------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 2, 3])
def test_roundtrip_exact_at_os1(L):
    nt, nph = s2quad_size(L, 1)
    eye = constants.quad_sample_sh(L, nt, nph) @ constants.quad_project_sh(L, nt, nph)
    assert np.max(np.abs(eye - np.eye((L + 1) ** 2))) < 1e-12


def test_exact_degree_bound_is_sharp():
    nt, nph = s2quad_size(1, 2)
    assert s2quad_exact_degree(nt, nph) == 7
    ok = constants.quad_sample_sh(3, nt, nph) @ constants.quad_project_sh(3, nt, nph)
    assert np.max(np.abs(ok - np.eye(16))) < 1e-12
    bad = constants.quad_sample_sh(4, nt, nph) @ constants.quad_project_sh(4, nt, nph)
    assert np.max(np.abs(bad - np.eye(25))) > 1e-2


@pytest.mark.parametrize("L", [1, 2])
def test_polynomial_gate_exact_at_predicted_order(L):
    x = np.random.default_rng(0).normal(size=(5, (L + 1) ** 2))

    def squared(os):
        nt, nph = s2quad_size(L, os)
        v = x @ constants.quad_sample_sh(L, nt, nph)
        return v**2 @ constants.quad_project_sh(2 * L, nt, nph)

    assert np.max(np.abs(squared(2) - squared(4))) < 1e-12
    assert np.max(np.abs(squared(1) - squared(4))) > 1e-4


def test_sigmoid_aliasing_bounded_and_monotone():
    L = 2
    x = np.random.default_rng(0).normal(size=(5, (L + 1) ** 2)) * 0.5

    def proj(os):
        nt, nph = s2quad_size(L, os)
        v = _sigmoid(x @ constants.quad_sample_sh(L, nt, nph))
        return v @ constants.quad_project_sh(L, nt, nph)

    ref = proj(16)
    errs = [np.max(np.abs(proj(os) - ref)) for os in (1, 2, 4)]
    assert errs[0] < 1e-2
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 1e-9


# --------------------------------------------------------------------------
# Rep-level grid residency
# --------------------------------------------------------------------------


def test_rep_sh_quad_roundtrip_ticks_counters():
    L = 2
    x = random_irreps(L, (4, 3), seed=1)
    with conversion_stats(fresh=True) as stats:
        back = Rep.from_sh(torch.as_tensor(x), L).to_quad().to_sh()
    assert stats["sh_to_quad"] == 1 and stats["quad_to_sh"] == 1
    assert back.basis == "sh"
    assert_close(back.data.numpy(), x, "float32", tier="identity")


def test_rep_fourier_quad_legs():
    """fourier -> quad -> fourier uses the single-transform legs (one tick
    each) and is value-exact; the samples equal the reference's."""
    from repro.core.rep import Rep as RefRep

    L = 2
    x = random_irreps(L, (4,), seed=2)
    with conversion_stats(fresh=True) as stats:
        r = Rep.from_sh(torch.as_tensor(x), L).to_fourier("half").to_quad()
        back = r.to_fourier().to_sh()
    assert stats["fourier_to_quad"] == 1 and stats["quad_to_fourier"] == 1
    assert stats["sh_to_quad"] == 0 and stats["quad_to_sh"] == 0
    assert_close(back.data.numpy(), x, "float32", tier="transform")
    want = RefRep.from_sh(jnp.asarray(x), L).to_fourier("half").to_quad()
    assert r.data.shape == want.data.shape and r.form == "grid"
    assert_close(r.data.numpy(), np.asarray(want.data), "float32")


def test_rep_quad_error_paths():
    L = 1
    sh = Rep.from_sh(torch.as_tensor(random_irreps(L, (2,), seed=3)), L)
    with pytest.raises(ValueError, match="apply_pointwise requires"):
        sh.apply_pointwise(lambda v: v)
    q = sh.to_quad(os=2)
    with pytest.raises(ValueError, match="resampling"):
        q.to_quad(os=4)
    with pytest.raises(ValueError, match="cannot raise"):
        q.to_sh(L + 1)
    with pytest.raises(ValueError, match="form='grid'"):
        Rep(q.data, L, "quad", "dense")


def _gate_params(C, seed, numpy=False):
    rng = np.random.default_rng(seed)
    p = {"w1": (rng.normal(size=(C, 16)) * 0.3).astype(np.float32),
         "w2": (rng.normal(size=(16, C)) * 0.3).astype(np.float32)}
    return p if numpy else {k: torch.as_tensor(v) for k, v in p.items()}


def test_quad_gate_matches_gate_apply():
    """The gate is affine given its scalars, so the quadrature evaluation
    equals the SH gate at any oversampling, and the reference's."""
    L = 2
    x = random_irreps(L, (5, 4), seed=4)
    p = _gate_params(4, 5)
    ref = _gate_sh(p, torch.as_tensor(x)).numpy()
    for os in (1, 2):
        got = _gate_quad(p, torch.as_tensor(x), L, os=os).numpy()
        assert_close(got, ref, "float32", tier="transform")
    want = ref_gate_quad({k: jnp.asarray(v) for k, v in _gate_params(4, 5, True).items()},
                         jnp.asarray(x), L)
    assert_close(_gate_quad(p, torch.as_tensor(x), L).numpy(), np.asarray(want), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_gate_rotation_equivariance(dtype):
    """The gate's scalars are l=0, so gating commutes with rotation; bf16
    inputs are pre-quantized so both orders see the same values."""
    L = 2
    dt = getattr(torch, dtype)
    x32 = random_irreps(L, (6, 4), seed=6)
    if dtype == "bfloat16":
        x32 = torch.as_tensor(x32).to(dt).float().numpy()
    p = _gate_params(4, 7)
    ang = random_angles(8)
    gate_then_rot = rotate_irreps(_gate_quad(p, torch.as_tensor(x32).to(dt), L).float().numpy(),
                                  L, ang)
    rot_then_gate = _gate_quad(p, torch.as_tensor(rotate_irreps(x32, L, ang)).to(dt), L)
    assert rot_then_gate.dtype == dt
    assert_close(rot_then_gate.float().numpy(), gate_then_rot, dtype, tier="transform")
