"""The Hopper chain, pair, WKV6 and Mamba-2 SSD kernels on the card against
their plain versions (the chain and pair kernels at f32 and bf16 storage),
the served step as a CUDA graph, and the training path on the card (a step
on the chain kernel against one on the tree, a checkpoint restored onto the
CPU, a warm autotune cache).  Marked
``cuda``: these skip without an sm_90 GPU (run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``)."""
import importlib
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import constants
from repro_torch.kernels.gaunt_fused import (chain_plain, gaunt_chain_fused_hopper,
                                             gaunt_chain_fused_torch, gaunt_fused_hopper,
                                             kernel_stats, launch_pair_kernel,
                                             pair_kernel_constants, pair_plain,
                                             reset_kernel_stats)
from repro_torch.kernels.ops import gaunt_tp_fused
from repro_torch.kernels import mamba2 as mamba2_mod
# the package's own name `wkv6` is the wrapper function, as in the reference
wkv6_mod = importlib.import_module("repro_torch.kernels.wkv6")

pytestmark = pytest.mark.cuda


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the SSD cases and input draw of chip_smoke.py, plus odd sizes: P, N
# below a float4 and a P tile, and P = 80 (a partial second tile) with
# every head its own group; bf16 with odd N (rows the state pass cannot
# copy 4 bytes at a time: it loads them instead)
_CS = _chip_smoke()
_SSD_CASES = [c[1:] for c in _CS.SSD_CASES] + [
    (1, 6, 2, 6, 1, 5, 64, "ref", "float32"),
    (1, 128, 3, 80, 3, 64, 64, "ref", "float32"),
    (1, 128, 3, 6, 1, 5, 64, "ref", "bfloat16")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 GPU: the CUDA kernel has no CPU mode")
    from repro_torch.device import set_float32_policy

    set_float32_policy()
    return torch.device("cuda")


@pytest.mark.parametrize("Ls,Lout,gated", [((2, 2, 2), 2, True), ((2, 2, 2), 2, False),
                                           ((1, 1), 2, False), ((1, 2, 1, 2), 4, True)])
def test_kernel_matches_plain_on_card(cuda_device, Ls, Lout, gated):
    """Folded chains (every entry 'sh'): one launch, within the f32 tier of
    the plain version on the same folded matrices, and of the unfolded
    torus grid."""
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(8192, (L + 1) ** 2, device=cuda_device, generator=g) for L in Ls]
    gate = (tuple(torch.randn(8192, device=cuda_device, generator=g) for _ in range(2))
            if gated else None)
    reset_kernel_stats()
    got = gaunt_chain_fused_hopper(xs, Ls, Lout, gate=gate)
    assert kernel_stats()["gaunt_chain"] == 1
    want = gaunt_chain_fused_torch(xs, Ls, Lout, gate=gate)
    Ts, P = constants.chain_matrices(Ls, Lout, ("sh",) * len(Ls), "sh", pad_lanes=False)
    flat = [x.reshape(-1, x.shape[-1]) for x in xs]
    gs, gb = ((a.reshape(-1, 1) for a in gate) if gated else (None, None))
    torus = chain_plain(flat, [constants.to_torch(T, cuda_device) for T in Ts],
                        constants.to_torch(P, cuda_device), gs, gb)
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 3e-4 * scale
    assert (got - torus).abs().max().item() <= 3e-4 * scale


def test_chain_kernel_grid_entry_on_card(cuda_device):
    """A 'grid' entry runs unfolded (G = 144 torus samples, two sample tiles)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    Ls = (2, 1, 2)
    xs = [torch.complex(torch.randn(300, 5, 3, device=cuda_device, generator=g),
                        torch.randn(300, 5, 3, device=cuda_device, generator=g)),
          torch.randn(300, 4, device=cuda_device, generator=g),
          torch.randn(300, 9, device=cuda_device, generator=g)]
    entries = ("grid", "sh", "sh")
    assert constants.chain_matrices_folded(Ls, 3, entries, "sh")[1].shape[0] == 144
    reset_kernel_stats()
    got = gaunt_chain_fused_hopper(xs, Ls, 3, entries=entries)
    assert kernel_stats()["gaunt_chain"] == 1
    want = gaunt_chain_fused_torch(xs, Ls, 3, entries=entries)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 3e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B", [1, 7, 300, 512, 4099])
@pytest.mark.parametrize("L1,L2,Lout", _CS.PAIR_CASES)
def test_pair_kernel_matches_plain_on_card(cuda_device, L1, L2, Lout, B):
    g = torch.Generator(device="cuda").manual_seed(B)
    x1 = torch.randn(B, (L1 + 1) ** 2, device=cuda_device, generator=g)
    x2 = torch.randn(B, (L2 + 1) ** 2, device=cuda_device, generator=g)
    T1, T2, P = (constants.to_torch(a, cuda_device)
                 for a in constants.pair_matrices(L1, L2, Lout))
    reset_kernel_stats()
    got = launch_pair_kernel(x1, x2, *pair_kernel_constants(L1, L2, Lout, cuda_device))
    assert kernel_stats()["gaunt_pair"] == 1
    want = pair_plain(x1, x2, T1, T2, P)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    # 3xTF32 keeps 22 of each operand's 24 bits; the sums run in another order
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("Ls,Lout,entries,gated", [
    ((2, 2, 2), 2, ("sh",) * 3, True), ((2, 2, 2), 2, ("sh",) * 3, False),
    ((1, 1), 2, ("sh", "sh"), False), ((1, 2, 1, 2), 4, ("sh",) * 4, True),
    ((2, 1, 2), 3, ("grid", "sh", "sh"), True)])
def test_chain_kernel_bf16_matches_plain_on_card(cuda_device, Ls, Lout, entries, gated):
    """The bf16 mode: bf16 rows and T, f32 P, gate and output.  Kernel and
    plain version read the same bf16 values and sum in f32, so they agree
    to f32 roundings: the forward and the gate's f32 gradients within 1e-5;
    the operand gradients come back at bf16 (as in the reference), where f32
    sums that differ in the last bits may round to neighbouring bf16
    values, so within one bf16 ulp per element (`bf16_grad_err`)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = []
    for L, e in zip(Ls, entries):
        if e == "sh":
            xs.append(torch.randn(4099, (L + 1) ** 2, device=cuda_device, generator=g))
        else:
            xs.append(torch.complex(torch.randn(4099, 2 * L + 1, L + 1, device=cuda_device,
                                                generator=g),
                                    torch.randn(4099, 2 * L + 1, L + 1, device=cuda_device,
                                                generator=g)))
    gate = (tuple(torch.randn(4099, device=cuda_device, generator=g) for _ in range(2))
            if gated else None)
    results = []
    for fn in (gaunt_chain_fused_hopper, gaunt_chain_fused_torch):
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        gl = tuple(t.detach().clone().requires_grad_(True) for t in gate) if gated else None
        reset_kernel_stats()
        out = fn(leaves, Ls, Lout, entries=entries, dtype="bfloat16", gate=gl)
        stats = kernel_stats()
        assert out.dtype == torch.float32
        w = torch.randn(out.shape, device=cuda_device, generator=torch.Generator(
            device="cuda").manual_seed(3))
        grads = torch.autograd.grad((out * w).sum(), leaves + list(gl or ()))
        results.append((out.detach(), grads, stats))
    torch.cuda.synchronize()
    (o_k, g_k, s_k), (o_p, g_p, s_p) = results
    assert s_k["gaunt_chain_bf16"] == 1 and s_k["gaunt_chain"] == 0
    assert s_p["gaunt_chain_bf16"] == 0
    assert (o_k - o_p).abs().max().item() <= 1e-5 * max(1.0, o_p.abs().max().item())
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        a, b = torch.view_as_real(a) if a.is_complex() else a, \
            torch.view_as_real(b) if b.is_complex() else b
        if i < len(Ls):
            assert _CS.bf16_grad_err(a, b) <= 1.0
        else:
            assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("B", [1, 7, 300, 4099])
@pytest.mark.parametrize("L1,L2,Lout", _CS.PAIR_CASES)
def test_pair_kernel_bf16_matches_plain_on_card(cuda_device, L1, L2, Lout, B):
    """The bf16 mode: bf16 rows and T1, T2 (one m16n8k16 product per k-tile
    of 16), the 3xTF32 projection on f32 P; the plain version upcasts the
    same bf16 values and sums in f32."""
    g = torch.Generator(device="cuda").manual_seed(B)
    x1 = torch.randn(B, (L1 + 1) ** 2, device=cuda_device, generator=g).bfloat16()
    x2 = torch.randn(B, (L2 + 1) ** 2, device=cuda_device, generator=g).bfloat16()
    T1, T2, _ = (constants.to_torch(a, cuda_device, torch.bfloat16)
                 for a in constants.pair_matrices(L1, L2, Lout, dtype="bfloat16"))
    P = constants.to_torch(constants.pair_matrices(L1, L2, Lout)[2], cuda_device)
    reset_kernel_stats()
    got = launch_pair_kernel(x1, x2, *pair_kernel_constants(L1, L2, Lout, cuda_device,
                                                            torch.bfloat16))
    assert kernel_stats()["gaunt_pair_bf16"] == 1 and kernel_stats()["gaunt_pair"] == 0
    want = pair_plain(x1, x2, T1, T2, P)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


def test_pair_kernel_route_has_no_gradient_on_card(cuda_device):
    x = torch.randn(5, 9, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        gaunt_fused_hopper(x, x, 2, 2)
    reset_kernel_stats()
    with torch.no_grad():
        out = gaunt_tp_fused(x, x, 2, 2)
    assert out.shape == (5, 25) and not out.requires_grad
    assert kernel_stats()["gaunt_pair"] == 1


@pytest.mark.parametrize("B,T,H,K,chunk,decay", [(2, 32, 3, 8, 8, "uniform"),
                                                 (2, 48, 3, 16, 16, "uniform"),
                                                 (2, 40, 3, 64, 64, "uniform"),
                                                 (2, 256, 4, 64, 64, "uniform"),
                                                 (2, 128, 4, 64, 64, "extreme"),
                                                 (1, 2048, 2, 64, 64, "uniform")])
def test_wkv6_kernel_matches_plain_on_card(cuda_device, B, T, H, K, chunk, decay):
    g = torch.Generator(device="cuda").manual_seed(T + K)
    r, k, v = (torch.randn(B, T, H, K, device=cuda_device, generator=g) * 0.5
               for _ in range(3))
    if decay == "extreme":
        w = torch.full((B, T, H, K), 1e-6, device=cuda_device)
    else:
        w = 0.2 + 0.799 * torch.rand(B, T, H, K, device=cuda_device, generator=g)
    u = torch.randn(H, K, device=cuda_device, generator=g) * 0.3
    wkv6_mod.reset_kernel_stats()
    o, S = wkv6_mod.wkv6_hopper(r, k, v, w, u, chunk=chunk, return_state=True)
    assert wkv6_mod.kernel_stats()["wkv6"] == 1
    want_o, want_S = wkv6_mod.wkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    for got, want in ((o, want_o), (S, want_S)):
        err = (got - want).abs().max().item()
        # f32, the same chunked sums in another order: the f32 identity tier
        assert err <= 3e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("B,T,H,K,chunk", [(2, 256, 4, 64, 64), (1, 2048, 2, 64, 64),
                                           (2, 48, 3, 16, 16)])
def test_wkv6_kernel_bf16_rkv_equals_f32_upcast_on_card(cuda_device, B, T, H, K, chunk):
    """bf16 r, k, v (as the model feeds them; w, u float32) are read in place
    and upcast exactly: the same o and S as their float32 upcasts, one
    counted launch per call, and within the f32 tier of the plain version."""
    g = torch.Generator(device="cuda").manual_seed(T + K + 1)
    r, k, v = ((torch.randn(B, T, H, K, device=cuda_device, generator=g) * 0.5)
               .to(torch.bfloat16) for _ in range(3))
    w = 0.2 + 0.799 * torch.rand(B, T, H, K, device=cuda_device, generator=g)
    u = torch.randn(H, K, device=cuda_device, generator=g) * 0.3
    wkv6_mod.reset_kernel_stats()
    o, S = wkv6_mod.wkv6_hopper(r, k, v, w, u, chunk=chunk, return_state=True)
    assert wkv6_mod.kernel_stats()["wkv6"] == 1
    o32, S32 = wkv6_mod.wkv6_hopper(r.float(), k.float(), v.float(), w, u, chunk=chunk,
                                    return_state=True)
    assert wkv6_mod.kernel_stats()["wkv6"] == 2
    want_o, want_S = wkv6_mod.wkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert o.dtype == S.dtype == torch.float32
    for got, f32, want in ((o, o32, want_o), (S, S32, want_S)):
        assert (got - f32).abs().max().item() <= 1e-6
        err = (got - want).abs().max().item()
        assert err <= 3e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("dtype,V", [(torch.float32, 8), (torch.bfloat16, 12)])
def test_wkv6_kernel_odd_sizes_on_card(cuda_device, dtype, V):
    """The kernel's run-time-size paths: K = 6 (not a multiple of 4: r, k, w
    staged an element at a time), C = T = 30 (pad rows in the last tile),
    and in bf16 V = 12 (rows of v copied a quad at a time)."""
    B, T, H, K = 1, 30, 2, 6
    g = torch.Generator(device="cuda").manual_seed(V)
    r, k = (torch.randn(B, T, H, K, device=cuda_device, generator=g).to(dtype) * 0.5
            for _ in range(2))
    v = torch.randn(B, T, H, V, device=cuda_device, generator=g).to(dtype)
    w = 0.2 + 0.799 * torch.rand(B, T, H, K, device=cuda_device, generator=g)
    u = torch.randn(H, K, device=cuda_device, generator=g) * 0.3
    o, S = wkv6_mod.wkv6_hopper(r, k, v, w, u, chunk=64, return_state=True)
    want_o, want_S = wkv6_mod.wkv6_chunked(r, k, v, w, u, chunk=64, return_state=True)
    torch.cuda.synchronize()
    for got, want in ((o, want_o), (S, want_S)):
        err = (got - want).abs().max().item()
        assert err <= 3e-4 * max(1.0, want.abs().max().item()), err


def test_wkv6_kernel_route_has_no_gradient_on_card(cuda_device):
    r = torch.randn(1, 16, 2, 8, device=cuda_device, requires_grad=True)
    w = torch.full((1, 16, 2, 8), 0.9, device=cuda_device)
    u = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(RuntimeError, match="no gradient"):
        wkv6_mod.wkv6_hopper(r, r, r, w, u)
    with torch.no_grad():
        assert wkv6_mod.wkv6_hopper(r, r, r, w, u).shape == (1, 16, 2, 8)


@pytest.mark.parametrize("Bt,T,H,P,G,N,chunk,decay,dtype", _SSD_CASES)
def test_mamba2_kernel_matches_plain_on_card(cuda_device, Bt, T, H, P, G, N, chunk, decay,
                                             dtype):
    x, dt, A, B, C, D = _CS._ssd_inputs(Bt, T, H, P, G, N, decay, dtype, cuda_device,
                                        seed=T + N)
    mamba2_mod.reset_kernel_stats()
    y, h = mamba2_mod.mamba2_ssd_hopper(x, dt, A, B, C, D, chunk=chunk, return_state=True)
    assert mamba2_mod.kernel_stats()["mamba2_ssd"] == 1
    want_y, want_h = mamba2_mod.mamba2_ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                                                   return_state=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for got, want in ((y, want_y), (h, want_h)):
        err = (got - want).abs().max().item()
        # f32, the same chunked sums in another order, la summed in the same
        # order: well inside the f32 identity tier
        assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("T", [64, 2048])
def test_mamba2_two_pass_call_is_one_launch_on_card(cuda_device, T):
    """One chunk (T = C: the state pass writes a zero h_start, then the
    final h) and 32 chunks (the state pass's chain at full depth): one
    call enqueues both passes, counts one launch, and matches the plain
    version."""
    x, dt, A, B, C, D = _CS._ssd_inputs(1, T, 2, 64, 1, 64, "model", "bfloat16",
                                        cuda_device, seed=T)
    mamba2_mod.reset_kernel_stats()
    y, h = mamba2_mod.launch_mamba2_kernel(x, dt, A, B, C, D)
    assert mamba2_mod.kernel_stats()["mamba2_ssd"] == 1
    want_y, want_h = mamba2_mod.mamba2_ssd_chunked(x, dt, A, B, C, D, return_state=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for got, want in ((y, want_y), (h, want_h)):
        err = (got - want).abs().max().item()
        assert err <= _CS.SSD_VS_PLAIN_TOL * max(1.0, want.abs().max().item()), err


def test_mamba2_kernel_reads_split_views_on_card(cuda_device):
    """x, B and C as the model hands them over: views of one bf16 conv
    output row [x | B | C], read in place (no copy, one launch) and equal
    to the kernel on contiguous copies and to the plain version."""
    Bt, T, H, P, G, N = 2, 128, 4, 16, 2, 16
    g = torch.Generator(device="cuda").manual_seed(7)
    row = torch.randn(Bt, T, H * P + 2 * G * N, device=cuda_device,
                      generator=g).bfloat16()
    xc, Bm, Cm = torch.split(row, [H * P, G * N, G * N], dim=-1)
    x, B, C = xc.reshape(Bt, T, H, P), Bm.reshape(Bt, T, G, N), Cm.reshape(Bt, T, G, N)
    assert not x.is_contiguous() and x.data_ptr() == row.data_ptr()
    dt = 0.01 + 0.19 * torch.rand(Bt, T, H, device=cuda_device, generator=g)
    A = -(0.5 + 1.5 * torch.rand(H, device=cuda_device, generator=g))
    D = torch.randn(H, device=cuda_device, generator=g)
    mamba2_mod.reset_kernel_stats()
    y, h = mamba2_mod.launch_mamba2_kernel(x, dt, A, B, C, D)
    assert mamba2_mod.kernel_stats()["mamba2_ssd"] == 1
    y2, h2 = mamba2_mod.launch_mamba2_kernel(x.contiguous(), dt, A, B.contiguous(),
                                             C.contiguous(), D)
    want_y, want_h = mamba2_mod.mamba2_ssd_chunked(x, dt, A, B, C, D, return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for got, want in ((y, want_y), (h, want_h)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


def test_mamba2_kernel_route_has_no_gradient_on_card(cuda_device):
    x = torch.randn(1, 16, 2, 8, device=cuda_device, requires_grad=True)
    dt = torch.full((1, 16, 2), 0.1, device=cuda_device)
    A, D = -torch.ones(2, device=cuda_device), torch.ones(2, device=cuda_device)
    Bm = torch.randn(1, 16, 1, 8, device=cuda_device)
    with pytest.raises(RuntimeError, match="no gradient"):
        mamba2_mod.mamba2_ssd_hopper(x, dt, A, Bm, Bm, D)
    with torch.no_grad():
        assert mamba2_mod.mamba2_ssd_hopper(x, dt, A, Bm, Bm, D).shape == (1, 16, 2, 8)


# --------------------------------------------------------------------------
# the served step as a CUDA graph (serve/pools.py)
# --------------------------------------------------------------------------

def _graph_model(cuda_device, channels=8):
    import dataclasses

    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.models.equivariant import MaceGaunt

    cfg = dataclasses.replace(gaunt_mace_ff, channels=channels, n_species=4,
                              chain_tune="measure", grid_gate="on")
    return MaceGaunt(cfg, device=cuda_device, generator=torch.Generator().manual_seed(3))


def _graph_requests(sizes, seed):
    import numpy as np

    from repro_torch.serve.engine import EquivariantRequest

    rng = np.random.default_rng(seed)
    return [EquivariantRequest(species=rng.integers(0, 4, n),
                               pos=(rng.normal(size=(n, 3)) * 1.5).astype(np.float32), rid=i)
            for i, n in enumerate(sizes)]


def _kernel_pick(model, pool):
    """Pin the served chain key of ``pool`` to the kernel inside the block,
    so that the step launches it whatever the measurement at this small size
    would pick."""
    from repro_torch.core.engine import get_engine

    c = model.cfg
    key = get_engine().chain_measure_key(
        (c.L,) * c.nu, c.L, c.compute_dtype, pool.spec.n_slots * pool.spec.max_atoms * c.channels,
        (0,) * c.nu, True, model.device)
    return get_engine().pinned_chain(key, "fused_hopper")


def test_graph_step_equals_eager_evaluate_on_card(cuda_device):
    from repro_torch.serve.engine import EquivariantServeEngine

    model = _graph_model(cuda_device)
    eng = EquivariantServeEngine(model, buckets=[(8, 2), (16, 2)], warmup=True)
    for pool, sizes in zip(eng.pools, ([5, 8], [12, 16])):
        for r in _graph_requests(sizes, seed=len(sizes) + sizes[0]):
            assert pool.admit(r)
        pool.stage()
        e, f = (t.clone() for t in pool.step_staged())
        e0, f0 = pool.evaluate(pool.species, pool.pos, pool.mask)
        torch.cuda.synchronize()
        de = (e - e0).abs().max().item()
        df = (f - f0).abs().max().item()
        print(f"bucket {pool.spec.label()}: graph vs eager max abs energy {de:.3e}, "
              f"forces {df:.3e}")
        assert pool.compiled() and pool.replays >= 2   # warmup, then this step
        assert de <= 3e-4 * max(1.0, e0.abs().max().item())
        assert df <= 3e-4 * max(1e-30, f0.abs().max().item())


def test_graph_replay_counts_the_eager_launches_on_card(cuda_device):
    from repro_torch.serve.pools import BucketSpec, SlotPool

    model = _graph_model(cuda_device)
    pool = SlotPool(model, BucketSpec(8, 2))
    for r in _graph_requests([6, 8], seed=1):
        assert pool.admit(r)
    with _kernel_pick(model, pool):
        reset_kernel_stats()
        pool.evaluate(pool.species, pool.pos, pool.mask)
        eager = kernel_stats()["gaunt_chain"]
        assert eager == model.cfg.n_layers  # one forward launch a layer
        pool.stage()
        pool.step_staged()                  # warmup iterations, capture, replay
        reset_kernel_stats()
        for _ in range(3):
            pool.step_staged()
        torch.cuda.synchronize()
    assert pool.launches == {"gaunt_chain": eager}
    assert kernel_stats()["gaunt_chain"] == 3 * eager


def test_bucket_without_traffic_never_captures_on_card(cuda_device):
    from repro_torch.serve.engine import EquivariantServeEngine

    model = _graph_model(cuda_device)
    eng = EquivariantServeEngine(model, buckets=[(6, 2), (16, 2)])
    small, large = eng.pools
    out = eng.run(_graph_requests([3, 4, 5, 6], seed=2))
    assert all(r.done and not r.rejected for r in out)
    assert small.compiled() and small.graph_bytes is not None and small.replays > 0
    assert not large.compiled() and large._graph is None and large.replays == 0


def test_select_chain_raises_under_capture_on_card(cuda_device):
    from repro_torch.core.engine import get_engine, plan_chain

    runs = get_engine().timing_runs
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="not measured"):
        with torch.cuda.graph(graph):
            plan_chain((1, 1, 1), 1, tune="measure", batch_hint=3333, share_hint=(0, 0, 0),
                       device=cuda_device)
    assert get_engine().timing_runs == runs


def test_graph_replay_after_stage_sees_new_positions_on_card(cuda_device):
    from repro_torch.serve.pools import BucketSpec, SlotPool

    model = _graph_model(cuda_device)
    pool = SlotPool(model, BucketSpec(8, 2))
    for r in _graph_requests([7, 8], seed=4):
        assert pool.admit(r)
    pool.warmup_compile()
    e1 = pool.step_staged()[0].clone()
    pool.pos[0, 0] += 0.3                   # a relaxation's write (not a translation)
    pool._dirty = True
    pool.stage()
    e2, f2 = (t.clone() for t in pool.step_staged())
    e0, f0 = pool.evaluate(pool.species, pool.pos, pool.mask)
    torch.cuda.synchronize()
    assert (e2[0] - e1[0]).abs().item() > 0          # slot 0 moved
    assert (e2[1] - e1[1]).abs().item() == 0         # slot 1 did not
    assert (e2 - e0).abs().max().item() <= 3e-4 * max(1.0, e0.abs().max().item())
    assert (f2 - f0).abs().max().item() <= 3e-4 * max(1e-30, f0.abs().max().item())


# --------------------------------------------------------------------------
# training on the card (train/loop.py, checkpoint/, core/autotune_cache.py)
# --------------------------------------------------------------------------

def _train_batch(cuda_device, n_mol=2, n_atoms=8):
    from repro_torch.data import lj_dataset

    d = lj_dataset(n_mol, n_atoms=n_atoms, n_species=4, seed=5)
    return {k: torch.as_tensor(v, device=cuda_device) for k, v in d.items()}


def test_train_step_kernel_matches_tree_on_card(cuda_device):
    """One training step (loss, double backward, clip, AdamW) with the chain
    pinned to the kernel and one pinned to the tree, from the same
    parameters and batch: the loss at 3e-4, every gradient at 2e-3
    (scale-relative), one `gaunt_chain` launch a layer."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.engine import get_engine
    from repro_torch.train import make_train_step

    batch = _train_batch(cuda_device)
    c = _graph_model(cuda_device).cfg
    rows = batch["pos"].shape[0] * batch["pos"].shape[1] * c.channels
    key = get_engine().chain_measure_key((c.L,) * c.nu, c.L, c.compute_dtype, rows,
                                         (0,) * c.nu, True, cuda_device)
    out = {}
    for backend in ("tree", "fused_hopper"):
        model = _graph_model(cuda_device)
        step, opt = make_train_step(lambda m, b: (m.loss(b), {}),
                                    TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4))
        params = dict(model.named_parameters())
        with get_engine().pinned_chain(key, backend):
            reset_kernel_stats()
            loss = model.loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()))
            launches = kernel_stats()["gaunt_chain"]
            _, m = step(model, opt.init(params), batch)
        torch.cuda.synchronize()
        out[backend] = (loss.item(), [g.detach() for g in grads], launches, m)
    (lt, gt, nt, _), (lk, gk, nk, mk) = out["tree"], out["fused_hopper"]
    assert nt == 0 and nk == c.n_layers
    assert abs(lk - lt) <= 3e-4 * max(1.0, abs(lt))
    # per parameter, relative to its largest element; a leaf whose gradient
    # is zero up to rounding (~1e-12 here) at f32 rounding of the largest
    top = max(b.abs().max().item() for b in gt)
    for a, b in zip(gk, gt):
        scale = max(b.abs().max().item(), 1e-6 * top)
        assert (a - b).abs().max().item() <= 2e-3 * scale
    assert torch.isfinite(mk["loss"]) and torch.isfinite(mk["grad_norm"])


def test_checkpoint_saved_on_card_restores_on_cpu(cuda_device, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import adamw, constant_schedule

    model = _graph_model(cuda_device)
    opt_state = adamw(constant_schedule(1e-3)).init(dict(model.named_parameters()))
    opt_state["mu"]["species"].normal_()
    tree = {"model": model.state_dict(), "opt": opt_state}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    mgr.wait()
    cpu_target = {"model": {k: v.cpu() for k, v in tree["model"].items()},
                  "opt": {"mu": {k: v.cpu() for k, v in opt_state["mu"].items()},
                          "nu": {k: v.cpu() for k, v in opt_state["nu"].items()},
                          "step": opt_state["step"]}}
    restored, _ = mgr.restore(1, cpu_target, device="cpu")
    for k, v in tree["model"].items():
        assert restored["model"][k].device.type == "cpu"
        assert torch.equal(restored["model"][k], v.cpu())
    assert torch.equal(restored["opt"]["mu"]["species"], opt_state["mu"]["species"].cpu())


def test_warm_autotune_cache_zero_timing_runs_on_card(cuda_device, tmp_path):
    from repro_torch.core import autotune_cache
    from repro_torch.core.engine import GauntEngine

    path = str(tmp_path / "cache.json")
    cold = GauntEngine(cache_path=path)
    kw = dict(tune="measure", batch_hint=8192, share_hint=(0, 0, 0), gate=True,
              device=cuda_device)
    pick = cold.plan_chain((2, 2, 2), 2, **kw).backend
    assert cold.timing_runs == 1
    fp = autotune_cache.fingerprint()
    assert fp["device_type"] == "cuda" and fp["capability"] == [9, 0]
    warm = GauntEngine(cache_path=path)
    assert warm.plan_chain((2, 2, 2), 2, **kw).backend == pick
    assert warm.timing_runs == 0
