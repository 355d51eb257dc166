"""The port's engine plan layer against the reference's: the backend
registry per kind, heuristic selection under the backend-name map, the
gradless kernel backend, measured selection on the CPU, conv_filter and
channel_mix plans per backend, and the cost-model calibration.

Name map: the reference's ``fused_xla`` / ``fused_pallas`` are the port's
``fused_torch`` / ``fused_hopper``.  Tolerance: f32 identity tier 3e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.kernels.ops import gaunt_tp_channel_mix as ref_channel_mix
from repro.testing import assert_close
from repro_torch.core import engine as port_engine
from repro_torch.kernels.ops import gaunt_tp_channel_mix, gaunt_tp_fused, gaunt_tp_fused_torch

TO_PORT = {"fused_xla": "fused_torch", "fused_pallas": "fused_hopper"}
TO_REF = {v: k for k, v in TO_PORT.items()}
PORTED_KINDS = ("pairwise", "conv_filter", "channel_mix")


@pytest.fixture(autouse=True)
def default_calibration():
    """Both cost models at their default calibration and both engines with
    no cached plan (another test of the process may have calibrated the
    reference's, and its plan cache keeps a pick made under that factor)."""
    ref_engine.get_engine().clear()
    port_engine.get_engine().clear()
    yield
    ref_engine.get_engine().clear()
    port_engine.get_engine().clear()


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _unit(shape, seed):
    v = np.random.default_rng(seed).normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("requires_grad", [True, False])
@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_available_backends_match_reference(kind, requires_grad):
    want = [TO_PORT.get(b, b) for b in ref_engine.available_backends(
        kind, requires_grad=requires_grad)]
    assert port_engine.available_backends(kind, requires_grad=requires_grad) == want


@pytest.mark.parametrize("kind", PORTED_KINDS)
@pytest.mark.parametrize("L", range(1, 9))
def test_heuristic_select_matches_reference_on_cpu(L, kind):
    eng, ref = port_engine.GauntEngine(), ref_engine.GauntEngine()
    for B in (1, 64, 1024, 81920):
        for rg in (True, False):
            pk = port_engine.PlanKey(L, L, L, kind, B, "float32", (), "cpu")
            rk = ref_engine.PlanKey(L, L, L, kind, B, "float32")
            want = ref.select(rk, requires_grad=rg)
            assert eng.select(pk, requires_grad=rg) == TO_PORT.get(want, want), (B, rg)


def test_kernel_cost_is_halved_on_the_card_and_penalized_off_it():
    cuda = port_engine.PlanKey(6, 6, 6, "pairwise", 81920, "float32", (), "cuda")
    cpu = port_engine.PlanKey(6, 6, 6, "pairwise", 81920, "float32", (), "cpu")
    spec = port_engine._REGISTRY["fused_hopper"]
    plain = port_engine._REGISTRY["fused_torch"]
    assert spec.cost(cuda) == pytest.approx(0.5 * plain.cost(cuda))
    assert spec.cost(cpu) == pytest.approx(1e4 * plain.cost(cpu))


def test_fused_hopper_is_refused_with_grad():
    with pytest.raises(ValueError, match="cannot serve"):
        port_engine.plan(2, 2, 4, backend="fused_hopper", requires_grad=True, device="cpu")
    eng = port_engine.GauntEngine()
    for B in (1, 64, 81920):
        key = port_engine.PlanKey(2, 2, 4, "pairwise", B, "float32", (), "cuda")
        assert eng.select(key, requires_grad=True) != "fused_hopper"
    p = port_engine.plan(2, 2, 4, backend="fused_hopper", requires_grad=False, device="cpu")
    assert p.backend == "fused_hopper"


def test_measure_on_cpu_never_times_the_kernel():
    eng = port_engine.GauntEngine()
    p = eng.plan(2, 2, 4, batch_hint=16, tune="measure", requires_grad=False, device="cpu")
    times = eng.measured_times[p.key]
    assert "fused_hopper" not in times
    assert set(times) == set(port_engine.available_backends("pairwise")) - {"fused_hopper"}
    assert p.backend == min(times, key=times.get) and eng.timing_runs == 1
    # the measured pick is cached: planning again times nothing
    assert eng.plan(2, 2, 4, batch_hint=16, tune="measure", requires_grad=False,
                    device="cpu") is p
    assert eng.timing_runs == 1
    eng.clear()
    assert eng.plans() == [] and eng.timing_runs == 0 and not eng.measured_times


def test_measure_skips_a_failing_plain_backend_and_records_it():
    def broken(key):
        raise RuntimeError("no such realization")

    eng = port_engine.GauntEngine()
    key = port_engine.PlanKey(1, 1, 2, "pairwise", 8, "float32", (), "cpu")
    bad = port_engine.Backend("broken", frozenset({"pairwise"}), build=broken,
                              cost=lambda k: 0.0)
    assert eng._measure(key, [bad, port_engine._REGISTRY["dense_einsum"]]) == "dense_einsum"
    assert "no such realization" in eng.measure_errors[key]["broken"]
    assert eng._measure(key, [bad]) is None


CONV_BACKENDS = ["escn_aligned", "dense_einsum", "fft", "direct", "packed", "rfft",
                 "fused_torch", "fused_hopper"]


@pytest.mark.parametrize("backend", CONV_BACKENDS)
@pytest.mark.parametrize("L1,L2,Lout", [(2, 3, 2), (3, 2, 4)])
def test_conv_filter_backend_matches_reference(L1, L2, Lout, backend):
    x = _rand((9, (L1 + 1) ** 2), L1)
    rhat = _unit((9,), L2)
    w2 = _rand((9, L2 + 1), 3)
    p = port_engine.plan(L1, L2, Lout, kind="conv_filter", backend=backend,
                         requires_grad=False, device="cpu")
    got = p.apply(torch.as_tensor(x), torch.as_tensor(rhat), w2=torch.as_tensor(w2))
    rp = ref_engine.plan(L1, L2, Lout, kind="conv_filter",
                         backend=TO_REF.get(backend, backend), requires_grad=False)
    want = np.asarray(rp.apply(jnp.asarray(x), jnp.asarray(rhat), w2=jnp.asarray(w2)))
    assert_close(got.numpy(), want, dtype="float32")


def test_conv_filter_wigner_geometry_matches_raw_directions():
    from repro_torch.core.conv import WignerBlocks

    L1, L2, Lout = 2, 3, 3
    x = torch.as_tensor(_rand((6, 9), 20))
    rhat = torch.as_tensor(_unit((6,), 21))
    raw = port_engine.plan(L1, L2, Lout, kind="conv_filter", backend="escn_aligned",
                           device="cpu")
    geo = port_engine.plan(L1, L2, Lout, kind="conv_filter", backend="escn_aligned",
                           options={"geometry": "wigner"}, device="cpu")
    assert geo.key.opt("geometry") == "wigner" and geo is not raw
    got = geo.apply(x, WignerBlocks.from_rhat(rhat, max(L1, Lout)))
    assert_close(got.numpy(), raw.apply(x, rhat).numpy(), dtype="float32")
    with pytest.raises(ValueError, match="cannot serve"):
        port_engine.plan(L1, L2, Lout, kind="conv_filter", backend="fft",
                         options={"geometry": "wigner"}, device="cpu")


@pytest.mark.parametrize("backend", ["fused_torch", "dense_einsum"])
def test_channel_mix_matches_reference(backend):
    L1, L2, Lout = 2, 3, 4
    x1, x2 = _rand((5, 3, 9), 30), _rand((5, 2, 16), 31)
    w = _rand((3, 2, 4), 32)
    want = np.asarray(ref_channel_mix(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w),
                                      L1, L2, Lout))
    if backend == "fused_torch":
        got = gaunt_tp_channel_mix(*(torch.as_tensor(a) for a in (x1, x2, w)),
                                   L1, L2, Lout, device="cpu")
    else:
        got = port_engine.plan(L1, L2, Lout, kind="channel_mix", backend=backend,
                               device="cpu").apply(*(torch.as_tensor(a) for a in (x1, x2, w)))
    assert got.shape == (5, 4, 25)
    assert_close(got.numpy(), want, dtype="float32")


def test_ops_wrappers_match_each_other_on_cpu():
    x1, x2 = torch.as_tensor(_rand((2, 7, 16), 40)), torch.as_tensor(_rand((2, 7, 16), 41))
    a = gaunt_tp_fused(x1, x2, 3, 3, 4, device="cpu")
    b = gaunt_tp_fused_torch(x1, x2, 3, 3, 4, device="cpu")
    assert a.shape == b.shape == (2, 7, 25)
    assert_close(a.numpy(), b.numpy(), dtype="float32")


def test_calibration_set_and_reset_track_the_reference():
    keys = [(L, B) for L in (1, 3, 6) for B in (1, 64, 4096)]

    def picks():
        eng, ref = port_engine.GauntEngine(), ref_engine.GauntEngine()
        out = []
        for L, B in keys:
            pk = port_engine.PlanKey(L, L, L, "pairwise", B, "float32", (), "cpu")
            rk = ref_engine.PlanKey(L, L, L, "pairwise", B, "float32")
            r = ref.select(rk, requires_grad=False)
            out.append((eng.select(pk, requires_grad=False), TO_PORT.get(r, r)))
        return out

    default = picks()
    assert all(p == r for p, r in default)
    for factor in (0.25, 16.0):
        port_engine.set_calibration(fused_skinny=factor, fused_skinny_measured=True)
        ref_engine.set_calibration(fused_skinny=factor, fused_skinny_measured=True)
        assert port_engine.get_calibration()["fused_skinny"] == factor
        moved = picks()
        assert all(p == r for p, r in moved)
        # a cheaper skinny-matmul factor moves some picks to the fused route
        assert (moved != default) == (factor < 4.0)
    port_engine.reset_calibration()
    ref_engine.reset_calibration()
    assert port_engine.get_calibration() == ref_engine.get_calibration() == \
        port_engine._CALIB_DEFAULTS
    assert picks() == default
    with pytest.raises(ValueError, match="unknown calibration"):
        port_engine.set_calibration(no_such_constant=1.0)
    port_engine.set_calibration(fused_skinny=0.25)
    port_engine.GauntEngine().clear()
    assert port_engine.get_calibration()["fused_skinny"] == 4.0


def test_plan_rejects_what_is_not_ported():
    # the manybody kind is ported: it needs Ls, as the reference's does, and
    # its plan computes the reference's product
    with pytest.raises(ValueError, match="Ls"):
        port_engine.plan(kind="manybody", device="cpu")
    xs = [_rand((3, 9), 40 + i) for i in range(3)]
    pm = port_engine.plan(kind="manybody", Ls=(2, 2, 2), Lout=2, backend="fft", device="cpu")
    assert pm.key.opt("Ls") == (2, 2, 2) and pm.key.kind == "manybody"
    want = ref_engine.plan(kind="manybody", Ls=(2, 2, 2), Lout=2, backend="fft").apply(
        [jnp.asarray(x) for x in xs])
    assert_close(pm.apply([torch.as_tensor(x) for x in xs]).numpy(), np.asarray(want),
                 dtype="float32")
    # Fourier boundaries are ported on the spectral backends only
    pf = port_engine.plan(2, 2, 4, options={"boundary": ("fourier", "sh", "sh")},
                          device="cpu")
    assert pf.key.opt("boundary") == ("fourier", "sh", "sh")
    with pytest.raises(ValueError, match="cannot serve"):
        port_engine.plan(2, 2, 4, options={"boundary": ("fourier", "sh", "sh")},
                         backend="dense_einsum", device="cpu")
    # 'auto' resolves to float32 under heuristic tuning, with no timing
    eng = port_engine.GauntEngine()
    assert eng.plan(2, 2, 4, dtype="auto", device="cpu").key.dtype == "float32"
    assert eng.timing_runs == 0
    # bf16 storage is ported: the plan keys on it
    pb = port_engine.plan(2, 2, 4, dtype="bfloat16", device="cpu")
    assert pb.key.dtype == "bfloat16" and pb is not port_engine.plan(2, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="selection rule"):
        port_engine.plan(2, 2, 5, device="cpu")
    p = port_engine.plan(2, 2, 4, options={"boundary": ("sh", "sh", "sh")}, device="cpu")
    assert p is port_engine.plan(2, 2, 4, device="cpu") and p.key.extra == ()
