"""The port's Mamba-2 SSD scan (plain version and kernel wrapper) against the
JAX reference: `mamba2_ssd_chunked` (output and final state),
`mamba2_ssd_pallas` in interpret mode and the naive recurrence
`mamba2_ssd_ref`, on the shapes of the reference's kernel tests (G = 2
groups of heads), a prompt shorter than the chunk, and strong and weak
decay, at the f32 identity tier (3e-4 scale-relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2 import mamba2_ssd_chunked as jmamba2_ssd_chunked
from repro.kernels.mamba2 import mamba2_ssd_pallas
from repro.testing import assert_close
from repro_torch.kernels import ops
from repro_torch.kernels.mamba2 import (_cumsum_seq, kernel_stats, launch_mamba2_kernel,
                                        mamba2_ssd_chunked, mamba2_ssd_hopper)
from repro_torch.kernels.ref import mamba2_ssd_ref


def _inputs(Bt, T, H, P, G, N, seed, decay="ref"):
    """x, dt, A, B, C, D as tests/test_kernels.py draws them (numpy, f32):
    dt ~ U(0.01, 0.2), A ~ -U(0.5, 2).  "strong": A = -8, dt up to 5 (A dt
    down to -40 a step); "weak": A dt ~ -1e-4."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, T, H, P))
    if decay == "ref":
        dt = rng.uniform(0.01, 0.2, size=(Bt, T, H))
        A = -rng.uniform(0.5, 2.0, size=(H,))
    elif decay == "strong":
        dt = rng.uniform(0.01, 5.0, size=(Bt, T, H))
        A = np.full((H,), -8.0)
    else:
        dt = rng.uniform(0.5, 1.5, size=(Bt, T, H))
        A = np.full((H,), -1e-4)
    B = rng.normal(size=(Bt, T, G, N))
    C = rng.normal(size=(Bt, T, G, N))
    D = rng.normal(size=(H,))
    return [a.astype(np.float32) for a in (x, dt, A, B, C, D)]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("T,chunk", [(32, 8), (64, 32), (40, 64)])
def test_mamba2_chunked_matches_reference(T, chunk):
    """The reference's test shapes (Bt 2, H 4, P 8, G 2, N 16) and T < chunk
    (C = T): output and final state against the reference's scan, output
    against both naive oracles."""
    arrs = _inputs(2, T, 4, 8, 2, 16, seed=13)
    y, h = mamba2_ssd_chunked(*_torch(arrs), chunk=chunk, return_state=True)
    jy, jh = jmamba2_ssd_chunked(*_jax(arrs), chunk=chunk, return_state=True)
    assert y.shape == (2, T, 4, 8) and h.shape == (2, 4, 8, 16)
    assert_close(y.numpy(), np.asarray(jy))
    assert_close(h.numpy(), np.asarray(jh))
    assert_close(y.numpy(), np.asarray(jref.mamba2_ssd_ref(*_jax(arrs))))
    assert_close(y.numpy(), mamba2_ssd_ref(*_torch(arrs)).numpy())
    assert torch.equal(mamba2_ssd_chunked(*_torch(arrs), chunk=chunk), y)


@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_mamba2_decay_edges_match_reference(decay):
    """A dt down to -40 a step stays finite (every exponent is masked before
    the exponential); A dt ~ -1e-4 carries the state across chunks."""
    arrs = _inputs(2, 128, 4, 16, 2, 16, seed=14, decay=decay)
    y, h = mamba2_ssd_chunked(*_torch(arrs), chunk=64, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    jy, jh = jmamba2_ssd_chunked(*_jax(arrs), chunk=64, return_state=True)
    assert_close(y.numpy(), np.asarray(jy))
    assert_close(h.numpy(), np.asarray(jh))
    assert_close(y.numpy(), np.asarray(jref.mamba2_ssd_ref(*_jax(arrs))))


def test_mamba2_ref_matches_reference_oracle():
    arrs = _inputs(2, 24, 6, 8, 3, 12, seed=15)
    assert_close(mamba2_ssd_ref(*_torch(arrs)).numpy(),
                 np.asarray(jref.mamba2_ssd_ref(*_jax(arrs))))


@pytest.mark.parametrize("Bt,T,H,P,G,N,chunk", [(1, 32, 2, 8, 1, 8, 8),
                                                (2, 32, 4, 8, 2, 16, 16)])
def test_mamba2_chunked_matches_pallas_interpret(Bt, T, H, P, G, N, chunk):
    arrs = _inputs(Bt, T, H, P, G, N, seed=16)
    got = mamba2_ssd_chunked(*_torch(arrs), chunk=chunk)
    want = mamba2_ssd_pallas(*_jax(arrs), chunk=chunk, interpret=True)
    assert_close(got.numpy(), np.asarray(want))


def test_mamba2_plain_gradient_matches_reference():
    """The plain version stays differentiable: its gradient equals jax.grad
    of the reference scan."""
    arrs = _inputs(1, 32, 4, 8, 2, 8, seed=17)
    cot = np.random.default_rng(18).normal(size=(1, 32, 4, 8)).astype(np.float32)
    ts = [t.requires_grad_(True) for t in _torch(arrs)]
    (mamba2_ssd_chunked(*ts, chunk=16) * torch.from_numpy(cot)).sum().backward()

    def loss(*a):
        return jnp.sum(jmamba2_ssd_chunked(*a, chunk=16) * cot)

    jg = jax.grad(loss, argnums=tuple(range(6)))(*_jax(arrs))
    for t, g in zip(ts, jg):
        assert_close(t.grad.numpy(), np.asarray(g), tier="loose")


def test_mamba2_hopper_runs_plain_version_for_cpu_tensors():
    arrs = _torch(_inputs(2, 32, 4, 8, 2, 16, seed=19))
    before = kernel_stats()["mamba2_ssd"]
    y, h = mamba2_ssd_hopper(*arrs, chunk=8, return_state=True)
    want_y, want_h = mamba2_ssd_chunked(*arrs, chunk=8, return_state=True)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert torch.equal(ops.mamba2_ssd(*arrs, chunk=8), want_y)
    assert kernel_stats()["mamba2_ssd"] == before  # no kernel launch on the CPU


def test_ops_mamba2_ssd_matches_reference_ops():
    from repro.kernels import ops as jops

    arrs = _inputs(2, 64, 4, 8, 2, 16, seed=20)
    assert_close(ops.mamba2_ssd(*_torch(arrs), chunk=32).numpy(),
                 np.asarray(jops.mamba2_ssd(*_jax(arrs), chunk=32)))


@pytest.mark.parametrize("fn", [mamba2_ssd_hopper, mamba2_ssd_chunked])
def test_mamba2_rejects_ragged_chunks(fn):
    """T = 100 is not a multiple of C = 64: raise, as the reference asserts;
    the prompt is not padded."""
    arrs = _torch(_inputs(1, 100, 2, 8, 1, 8, seed=21))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        fn(*arrs, chunk=64)


def test_mamba2_hopper_off_cpu_is_the_kernel():
    arrs = [t.to("meta") for t in _torch(_inputs(1, 32, 2, 8, 1, 8, seed=22))]
    with pytest.raises(ValueError, match="CUDA device"):
        mamba2_ssd_hopper(*arrs, chunk=8)
    with pytest.raises(ValueError, match="CUDA device"):
        launch_mamba2_kernel(*arrs, chunk=8)
    arrs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        mamba2_ssd_hopper(*arrs, chunk=8)


def test_model_scan_inputs_reach_the_kernel_uncopied():
    """The Mamba-2 mixer's x, B and C are views split from one conv output
    row; the wrapper hands them to the kernel as they are, with that row's
    stride, and copies only what the kernel cannot read in place."""
    from repro_torch.config import get_config
    from repro_torch.kernels.mamba2 import _as_rows, _token_stride
    from repro_torch.models import ssm

    cfg = get_config("zamba2-2.7b").reduced()
    p = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg)
    h = torch.from_numpy(np.random.default_rng(23).normal(size=(2, 32, cfg.d_model))
                         .astype(np.float32))
    _, conv_in, (x, _, _, B, C, _) = ssm.mamba2_scan_inputs(p, h, cfg)
    row = conv_in.shape[-1]
    for t in (x, B, C):
        assert not t.is_contiguous()
        assert _token_stride(t) == row and _as_rows(t) is t
    c = x.contiguous()
    assert _token_stride(c) == x.shape[2] * x.shape[3] and _as_rows(c) is c
    assert _token_stride(x[:, ::2]) == 2 * row  # every other token: still evenly spaced
    # not token rows: [H, P] transposed, sequences interleaved, a prefix of
    # each sequence (the sequences no longer follow one another evenly)
    for t in (x.transpose(2, 3), x.transpose(0, 1), x[:, :16]):
        assert _token_stride(t) is None
        assert _token_stride(_as_rows(t)) is not None


def _ssd_two_pass(x, dt, A, B, C, D, chunk):
    """The CUDA kernel's split of the chunked scan, in torch: the state pass
    (sequential over chunks, no C x C work) forms h at every chunk's start
    and the final h; the output pass then forms every chunk's output from
    its own inputs and its h_start alone, all chunks at once.  la is the
    kernel's sequential sum (`_cumsum_seq`)."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Ck = min(chunk, T)
    n = T // Ck
    R = Bt * H

    def to_r(a, d):  # [Bt,T,H,d] -> [R, n, Ck, d]
        return a.float().permute(0, 2, 1, 3).reshape(R, n, Ck, d)

    xs = to_r(x, P)
    Bs = to_r(B.repeat_interleave(H // G, dim=2), N)
    Cs = to_r(C.repeat_interleave(H // G, dim=2), N)
    dts = dt.float().permute(0, 2, 1).reshape(R, n, Ck)
    la = _cumsum_seq(A.float().repeat(Bt)[:, None, None] * dts)  # [R, n, Ck]
    # state pass: h <- exp(la_C) h + (x wd)^T B, wd_j = exp(la_C - la_j) dt_j
    wd = torch.exp(la[..., -1:] - la) * dts
    h = torch.zeros((R, P, N))
    starts = []
    for c in range(n):
        starts.append(h)
        xw = xs[:, c] * wd[:, c, :, None]
        h = torch.exp(la[:, c, -1])[:, None, None] * h + xw.transpose(1, 2) @ Bs[:, c]
    h_start = torch.stack(starts, 1)  # [R, n, P, N]
    # output pass: every chunk from its own inputs and h_start
    idx = torch.arange(Ck)
    mask = idx[:, None] >= idx[None, :]
    diff = la[..., :, None] - la[..., None, :]
    M = (torch.exp(torch.where(mask, diff, float("-inf"))) * (Cs @ Bs.transpose(-1, -2))
         * dts[..., None, :])
    y = M @ xs + torch.exp(la)[..., None] * (Cs @ h_start.transpose(-1, -2))
    y = y.reshape(Bt, H, T, P).permute(0, 2, 1, 3) + D.float()[None, None, :, None] * x.float()
    return y, h.reshape(Bt, H, P, N)


@pytest.mark.parametrize("Bt,T,H,P,G,N,chunk,decay",
                         [(2, 32, 4, 8, 2, 16, 8, "ref"), (2, 64, 4, 8, 2, 16, 32, "ref"),
                          (2, 40, 4, 8, 2, 16, 64, "ref"),
                          (1, 128, 4, 16, 2, 16, 32, "strong"),
                          (1, 128, 4, 16, 2, 16, 32, "weak"),
                          (1, 256, 2, 64, 1, 64, 64, "ref")])
def test_mamba2_two_pass_split_matches_reference(Bt, T, H, P, G, N, chunk, decay):
    """States at chunk starts first, then each chunk's output on its own:
    the same sums as the chunked scan in another order (f32 identity tier),
    output and final state, finite at A dt down to -40 a step."""
    arrs = _inputs(Bt, T, H, P, G, N, seed=30 + T + P, decay=decay)
    y, h = _ssd_two_pass(*_torch(arrs), chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    jy, jh = jmamba2_ssd_chunked(*_jax(arrs), chunk=chunk, return_state=True)
    assert_close(y.numpy(), np.asarray(jy))
    assert_close(h.numpy(), np.asarray(jh))


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("Bt,T,H,P,G,N", [(4, 2048, 80, 64, 1, 64), (2, 64, 4, 8, 2, 16)])
def test_ssd_bound_counts_the_rescaled_recurrence(Bt, T, H, P, G, N):
    """chip_smoke's SSD operation count is the WKV6 count's convention: the
    recurrence with a scalar decay per (head, step), rescaled, 4 P N FLOP
    per (token, head), as `wkv6_work` counts 4 K V (K = N, V = P); at
    zamba2-2.7b's prefill that is 10.7 GFLOP, 0.160 ms at 67 TFLOP/s."""
    cs = _chip_smoke()
    x = torch.empty((Bt, T, H, P), dtype=torch.bfloat16, device="meta")
    B = torch.empty((Bt, T, G, N), dtype=torch.bfloat16, device="meta")
    flops, nbytes = cs.mamba2_work(x, B)
    assert flops == 4 * P * N * Bt * T * H == cs.wkv6_work(Bt, T, H, N, P)[0]
    assert nbytes == (2 * (Bt * T * H * P + 2 * Bt * T * G * N)
                      + 4 * (Bt * T * H + 2 * H + Bt * T * H * P + Bt * H * P * N))
    if (Bt, T, H, P) == (4, 2048, 80, 64):
        bound_ms, bound_by = cs.bound_of(flops, nbytes)
        assert bound_by == "operations" and abs(bound_ms - 0.16026) < 1e-4
