"""The attention families at their served compute dtype, bf16, against the
JAX reference: each arch's ``reduced(dtype='bfloat16')`` config (2 layers,
d 128, 4 heads of 32, vocab 512; MoE 4 experts top-2), parameters from the
reference's ``init(PRNGKey(1))`` through `lm_params_from_jax` (f32 weights,
bf16 compute on both sides), the data of tests/test_torch_lm_families.py
(`_batch` at seed 0, B, S = 2, 32; vlm with grid positions3).

Held at the bf16 identity tier, ``tol_for('bfloat16')`` = 5e-2,
scale-relative: forward logits and the aux loss, prefill's last logits and
every cache leaf, one decode step from the reference's prefilled cache.
For dense, vlm and encdec also `Model.loss` (identity tier) and its
gradient over every parameter, each leaf relative to its norm at
`GRAD_TIER`, the tier of the port's bf16 gradient twins through a model
(tests/test_torch_bf16.py holds forces, -dE/dpos, there).

The MoE near-tie rule (qwen2-moe-a2.7b, dbrx-132b).  The port's router is
recorded by wrapping `repro_torch.models.moe._route`.  Every token within
the tier passes; a token beyond it passes only if, at it or at an earlier
position of its row, some layer's router margin in the port's run (the
k-th top probability minus the (k+1)-th) is under `near_tie_bound`, and at
most `MAX_PARTED` tokens of a config part.  At f32 the same forward agrees
at 3e-4 (test_torch_lm_families.py holds it too).

gemma-2b at its full depth, 18 layers (reduced width): the port against
the reference at f32, and each side's bf16 drift from its own f32 forward
and its bf16 prefill and decode against its own bf16 forward, the port's
within `DRIFT_FACTOR` of the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import compare, to_numpy
from test_torch_lm_families import _batch, _j, _leaves, _setup

from repro_torch.models import moe
from repro_torch.models.api import LMModule
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.testing import RouterLog, assert_close, near_tie_bound, pick_flips, tol_for

ATTENTION = ["qwen2-0.5b", "gemma-2b", "stablelm-3b", "qwen1.5-32b",  # dense
             "qwen2-vl-72b", "whisper-base"]                        # vlm, encdec
MOE = ["qwen2-moe-a2.7b", "dbrx-132b"]
B, S = 2, 32
BF16 = "bfloat16"
TOL = tol_for(BF16)                 # 5e-2
GRAD_TIER = "loose"                 # tol_for('bfloat16', 'loose') = 1.2e-1
MAX_PARTED = 4                      # of a config's 64 tokens
# the bf16 loss gap, absolute: four times the largest of the six configs'
# gaps (2.4e-3, stablelm-3b; test_loss_bf16_matches_reference prints them)
LOSS_ATOL = 1e-2


def _record(monkeypatch) -> RouterLog:
    """A `RouterLog` of the port's router, installed with ``monkeypatch``."""
    log = RouterLog()
    monkeypatch.setattr(moe, "_route", log.wrap(moe._route))
    return log


def token_errors(got, want, pos_axis: int = 1, batch_axis: int = 0):
    """max |got - want| per (row, position), over the scale of the whole of
    ``want`` (the scale-relative convention of `assert_close`) -> [B, T]."""
    scale = max(1.0, float(np.abs(want).max()))
    err = np.moveaxis(np.abs(got - want), (batch_axis, pos_axis), (0, 1))
    return err.reshape(err.shape[0], err.shape[1], -1).max(-1) / scale


def check_near_ties(err, log, tag: str, positions=None):
    """The rule: every (row, column) of ``err`` [B, T'] within the tier, or
    excused by a near tie of ``log`` (a `RouterLog`) at or before its
    position in its row (``positions[column]``, the column itself by
    default); at most MAX_PARTED parted.  Prints each parted token with the
    margin that excuses it.  -> the parted ones."""
    near = log.near().numpy()
    parted = [tuple(map(int, bt)) for bt in np.argwhere(err > TOL)]
    for b, c in parted:
        t = c if positions is None else positions[c]
        ties = np.flatnonzero(near[b, :t + 1]).tolist()
        print(f"{tag}: row {b} position {t} parts at {err[b, c]:.3e} of the scale; "
              f"near ties at positions {ties}, the closest at {log.nearest(b, t)}")
        assert ties, f"{tag}: row {b} position {t} parts ({err[b, c]:.3e}) with no near tie"
    assert len(parted) <= MAX_PARTED, (tag, parted)
    return parted


@functools.lru_cache(maxsize=None)
def _ref_forward(arch):
    cfg, jm, jparams, _, _ = _setup(arch, dtype=BF16)
    want, jaux = jax.jit(jm.forward)(jparams, _j(_batch(cfg)))
    return to_numpy(want), float(jaux)


@functools.lru_cache(maxsize=None)
def _ref_prefill(arch):
    cfg, jm, jparams, _, _ = _setup(arch, dtype=BF16)
    batch = _batch(cfg, positions3="text")
    return jax.jit(lambda p, b: jm.prefill(p, b, S + 8))(jparams, _j(batch))


def _cache_pairs(cache, jcache):
    want = {tuple(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    got = dict(_leaves(cache))
    assert set(got) == set(want)
    for k in sorted(got):
        g, w = to_numpy(got[k]), to_numpy(want[k])
        assert g.shape == w.shape, k
        yield k, g, w


# --------------------------------------------------------------------------
# dense, vlm, encdec: every comparison at the bf16 tier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ATTENTION)
def test_forward_bf16_matches_reference(arch):
    cfg, jm, jparams, model, params = _setup(arch, dtype=BF16)
    with torch.no_grad():
        got, want = compare(lambda b: jax.jit(jm.forward)(jparams, b),
                            lambda b: model.forward(params, b), [_batch(cfg)], dtype=BF16,
                            cast=False)
    assert got[0].shape == (B, S, cfg.vocab)
    assert float(got[1]) == 0.0 == float(want[1])


@pytest.mark.parametrize("arch", ATTENTION)
def test_prefill_bf16_matches_reference(arch):
    """The last logits and every cache leaf (bf16 on both sides)."""
    cfg, _, _, model, params = _setup(arch, dtype=BF16)
    want, jcache = _ref_prefill(arch)
    with torch.no_grad():
        got, cache = model.prefill(params, _batch(cfg, positions3="text"), S + 8)
    assert_close(to_numpy(got), to_numpy(want), dtype=BF16)
    assert all(a.dtype == torch.bfloat16 for _, a in _leaves(cache))
    for _, g, w in _cache_pairs(cache, jcache):
        assert_close(g, w, dtype=BF16)


def _decode(arch):
    cfg, jm, jparams, model, params = _setup(arch, dtype=BF16)
    batch = _batch(cfg, positions3="text")
    _, jcache = _ref_prefill(arch)
    cache = jax.tree.map(lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
                         .to(torch.bfloat16), jcache)
    tok, pos = batch["tokens"][:, 3:4], np.array([S, S - 5], np.int32)
    want, jnew = jax.jit(jm.decode_step)(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
    with torch.no_grad():
        got, new = model.decode_step(params, cache, tok, pos)
    return got, new, want, jnew


@pytest.mark.parametrize("arch", ATTENTION)
def test_decode_step_bf16_matches_reference(arch):
    """One decode step from the reference's own prefilled cache, converted."""
    got, new, want, jnew = _decode(arch)
    assert_close(to_numpy(got), to_numpy(want), dtype=BF16)
    for _, g, w in _cache_pairs(new, jnew):
        assert_close(g, w, dtype=BF16)


@functools.lru_cache(maxsize=None)
def _loss_twin(arch):
    """(the reference's loss, metrics and gradients, the port's loss,
    metrics and module after one backward) on `_batch` with next-token
    labels."""
    cfg, jm, jparams, _, params = _setup(arch, dtype=BF16)
    batch = _batch(cfg)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, _j(batch)), has_aux=True))(jparams)
    module = LMModule(cfg, jax.tree.map(lambda t: t.clone(), params))
    loss, met = module.loss(batch)
    loss.backward()
    grads = lm_params_from_jax(jax.tree.map(np.asarray, jgrads))
    return (float(jloss), {k: float(v) for k, v in jmet.items()}, grads), (loss, met, module)


@pytest.mark.parametrize("arch", ATTENTION)
def test_loss_bf16_matches_reference(arch):
    """At the identity tier, scale-relative, and absolutely within LOSS_ATOL
    (the tier alone lets ~0.3 through at a loss near ln 512)."""
    (jloss, jmet, _), (loss, met, _) = _loss_twin(arch)
    assert bool(torch.isfinite(loss))
    got = float(loss.detach())
    print(f"{arch} bf16 loss: port {got:.6f}, reference {jloss:.6f}, gap {abs(got - jloss):.3e}")
    for got, want in ((got, jloss), (float(met["ce"].detach()), jmet["ce"])):
        assert_close(np.float64(got), np.float64(want), dtype=BF16)
        assert abs(got - want) <= LOSS_ATOL, (got, want)


@pytest.mark.parametrize("arch", ATTENTION)
def test_grads_bf16_match_reference(arch):
    """Each parameter's gradient within tol_for('bfloat16', GRAD_TIER) of
    the reference's, relative to that leaf's norm."""
    (_, _, grads), (_, _, module) = _loss_twin(arch)
    tol = tol_for(BF16, GRAD_TIER)
    n = 0
    flat = dict(_leaves(grads))
    for k, p in _leaves(module.tree()):
        g = flat[k]
        assert p.grad is not None and p.grad.shape == g.shape, k
        err = float((p.grad - g).norm())
        assert err <= tol * max(float(g.norm()), 1e-12), (k, err, float(g.norm()))
        n += 1
    assert n == len(flat) == len(list(module.parameters()))


# --------------------------------------------------------------------------
# MoE: the same comparisons under the near-tie rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_bf16_near_ties(arch, monkeypatch):
    cfg, _, _, model, params = _setup(arch, dtype=BF16)
    want, jaux = _ref_forward(arch)
    log = _record(monkeypatch)
    with torch.no_grad():
        got, aux = model.forward(params, _batch(cfg))
    assert len(log.calls) == cfg.n_layers
    check_near_ties(token_errors(to_numpy(got), want), log, f"{arch} forward")
    assert_close(np.float64(float(aux)), np.float64(jaux), dtype=BF16)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_f32_still_agrees(arch):
    """The same data and parameters at f32: every token at 3e-4."""
    cfg, jm, jparams, model, params = _setup(arch)
    with torch.no_grad():
        compare(lambda b: jax.jit(jm.forward)(jparams, b), lambda b: model.forward(params, b),
                [_batch(cfg)], cast=False)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_bf16_near_ties(arch, monkeypatch):
    """Prefill's last logits (the last position of each row) and every
    cache leaf [layers, B, T, ...] per (row, position), under the rule."""
    cfg, _, _, model, params = _setup(arch, dtype=BF16)
    want, jcache = _ref_prefill(arch)
    log = _record(monkeypatch)
    with torch.no_grad():
        got, cache = model.prefill(params, _batch(cfg, positions3="text"), S + 8)
    # the last logits [B, 1, V] sit at position S - 1 of each row
    check_near_ties(token_errors(to_numpy(got), to_numpy(want)), log,
                    f"{arch} prefill last logits", positions=[S - 1])
    for k, gc, wc in _cache_pairs(cache, jcache):
        check_near_ties(token_errors(gc[:, :, :S], wc[:, :, :S], pos_axis=2, batch_axis=1),
                        log, f"{arch} prefill cache {k}")


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_step_bf16_near_ties(arch, monkeypatch):
    """One decode step from the reference's prefilled cache: the new token
    of each row is its only position that can part."""
    log = _record(monkeypatch)
    got, new, want, jnew = _decode(arch)
    check_near_ties(token_errors(to_numpy(got), to_numpy(want)), log, f"{arch} decode step")


def test_near_tie_bound_covers_one_bf16_rounding():
    """The bound's derivation, checked: rounding router inputs to bf16
    swaps the k-th and (k+1)-th experts only at tokens whose margin is
    under the bound, and the bound is no blanket (most margins are above
    it)."""
    g = torch.Generator().manual_seed(0)
    d, E, k = 128, 4, 2
    x = torch.randn((20000, d), generator=g)
    w = torch.randn((d, E), generator=g) / d ** 0.5
    p32 = torch.softmax(x @ w, -1)
    p16 = torch.softmax(x.bfloat16().float() @ w, -1)
    swapped = (p32.topk(k, -1).indices.sort(-1).values
               != p16.topk(k, -1).indices.sort(-1).values).any(-1)
    margin, bound = near_tie_bound(x, w, p32, k)
    assert int(swapped.sum()) > 0
    assert bool((margin[swapped] <= bound[swapped]).all())
    assert float((margin <= bound).float().mean()) < 0.25


def test_pick_flips_explains_bf16_rounding_and_not_a_fault():
    """`pick_flips` between a run and the same router inputs rounded to bf16
    (a stand-in for a bf16 run): every flip under its measured-difference
    bound; against a router whose weight is off by 1e-2 of its scale, some
    flip is not."""
    g = torch.Generator().manual_seed(0)
    d, E, k = 128, 16, 4
    x = torch.randn((1, 4000, d), generator=g)
    w = torch.randn((d, E), generator=g) / d ** 0.5

    def run(xs, wp):
        log = RouterLog()
        with torch.no_grad():
            log.wrap(moe._route)({"router": {"w": wp}}, xs, k)
        log.calls[0] = log.calls[0]._replace(w=w)  # the bound uses the true weight
        return log

    a = run(x, w)
    flip, margin, bound = pick_flips(a, run(x.bfloat16(), w))
    assert int(flip.sum()) > 0
    assert bool((margin[flip] <= bound[flip]).all())
    wrong = w + 1e-2 * w.abs().mean() * torch.randn((d, E), generator=g)
    flip, margin, bound = pick_flips(a, run(x.bfloat16(), wrong))
    assert bool((margin[flip] > bound[flip]).any())


# --------------------------------------------------------------------------
# gemma-2b at its full depth, 18 layers (reduced width)
# --------------------------------------------------------------------------

DEEP = 18                   # gemma-2b's depth
DEEP_SEEDS = range(6)       # the batches of `_batch` at these seeds
DEEP_STEPS = 4              # decode steps after a prefill of S tokens
DRIFT_FACTOR = 1.25         # the port's figure over the reference's, at most


def _deep(dtype, one_offset=True):
    return _setup("gemma-2b", dtype=dtype, n_layers=DEEP, rms_one_offset=one_offset)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


@functools.lru_cache(maxsize=None)
def _deep_forwards(one_offset: bool):
    """{(side, dtype, seed): logits} of both sides' forwards at 18 layers."""
    out = {}
    for dt in ("float32", BF16):
        cfg, jm, jparams, model, params = _deep(dt, one_offset)
        fwd = jax.jit(jm.forward)
        for seed in DEEP_SEEDS:
            batch = _batch(cfg, seed=seed)
            out["reference", dt, seed] = to_numpy(fwd(jparams, _j(batch))[0])
            with torch.no_grad():
                out["port", dt, seed] = to_numpy(model.forward(params, batch)[0])
    return out


def test_gemma_18_layers_f32_matches_reference():
    """The function at gemma-2b's depth: the port's f32 forward against the
    reference's at the f32 identity tier, at every seed."""
    f = _deep_forwards(True)
    for seed in DEEP_SEEDS:
        assert_close(f["port", "float32", seed], f["reference", "float32", seed])


@pytest.mark.parametrize("one_offset", [True, False])
def test_gemma_18_layers_bf16_drift_tracks_reference(one_offset):
    """Each side's bf16 forward against its own f32 forward at 18 layers,
    over DEEP_SEEDS: the port's mean rel within DRIFT_FACTOR of the
    reference's.  gemma normalises by (1 + scale) and the reference's init
    sets every scale to 1, a gain of 2 in each norm, under which bf16
    rounding noise grows layer by layer: the reference's own mean drift is
    past the bf16 loose tier (1.2e-1), and with the offset off it is not."""
    f = _deep_forwards(one_offset)
    drift = {side: [_rel(f[side, BF16, s], f[side, "float32", s]) for s in DEEP_SEEDS]
             for side in ("reference", "port")}
    ref, port = float(np.mean(drift["reference"])), float(np.mean(drift["port"]))
    print(f"gemma-2b reduced, {DEEP} layers, rms_one_offset={one_offset}: bf16 forward vs f32 "
          f"forward rel per seed: reference {np.round(drift['reference'], 4).tolist()} "
          f"(mean {ref:.4f}), port {np.round(drift['port'], 4).tolist()} (mean {port:.4f})")
    assert port <= DRIFT_FACTOR * ref, (port, ref)
    assert (ref > tol_for(BF16, "loose")) == one_offset, ref


def _deep_identity(side: str):
    """bf16 at 18 layers, seed 0: the last logits of a prefill of S tokens
    and DEEP_STEPS decode steps, each against the same side's bf16 forward
    over S + DEEP_STEPS tokens at its position -> (prefill rel, worst
    decode rel), scale-relative."""
    cfg, jm, jparams, model, params = _deep(BF16)
    toks = _batch(cfg, T=S + DEEP_STEPS)["tokens"]
    pos = [np.full((B,), S + j, np.int32) for j in range(DEEP_STEPS)]
    if side == "reference":
        logits = to_numpy(jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(toks)})[0])
        last, cache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, S + DEEP_STEPS))(
            jparams, jnp.asarray(toks[:, :S]))
        step = jax.jit(jm.decode_step)
        steps = []
        for j in range(DEEP_STEPS):
            out, cache = step(jparams, cache, jnp.asarray(toks[:, S + j:S + j + 1]),
                              jnp.asarray(pos[j]))
            steps.append(to_numpy(out)[:, 0])
    else:
        with torch.no_grad():
            logits = to_numpy(model.forward(params, {"tokens": toks})[0])
            last, cache = model.prefill(params, {"tokens": toks[:, :S]}, S + DEEP_STEPS)
            steps = []
            for j in range(DEEP_STEPS):
                out, cache = model.decode_step(params, cache, toks[:, S + j:S + j + 1], pos[j])
                steps.append(to_numpy(out)[:, 0])
    rel_p = _rel(to_numpy(last)[:, 0], logits[:, S - 1])
    rel_d = max(_rel(steps[j], logits[:, S + j]) for j in range(DEEP_STEPS))
    return rel_p, rel_d


def test_gemma_18_layers_bf16_prefill_decode_match_forward():
    """The cache path at gemma-2b's depth at bf16: each side's prefill and
    decode steps against its own bf16 forward, printed side by side; the
    port's at the bf16 identity tier and within DRIFT_FACTOR of the
    reference's (above a floor of the f32 identity tier, where both are
    near 0)."""
    ref, port = _deep_identity("reference"), _deep_identity("port")
    print(f"gemma-2b reduced, {DEEP} layers, bf16: prefill vs forward rel reference "
          f"{ref[0]:.3e}, port {port[0]:.3e}; worst of {DEEP_STEPS} decode steps vs forward "
          f"rel reference {ref[1]:.3e}, port {port[1]:.3e}")
    for r, p in zip(ref, port):
        assert p <= TOL and p <= DRIFT_FACTOR * r + tol_for("float32"), (ref, port)
