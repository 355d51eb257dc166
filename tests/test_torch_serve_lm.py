"""The port's LM `ServeEngine` on the CPU (its eager step): the twins of the
reference's five engine tests (``tests/test_training_substrate.py``),
greedy tokens equal to the reference `ServeEngine`'s on converted
parameters, admission validation, and the CPU rehearsal of the decode
step's capture: after one warm step, the in-place decode step makes no
tensor from host data, reads nothing back and sizes nothing by the data,
for every family and the int8 cache."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.config import get_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _leaves
from test_torch_serve_scale import _NoHostRoundTrip


@functools.lru_cache(maxsize=None)
def _model(arch: str, seed: int, **over):
    """A reduced ``arch`` on the CPU and its parameters from a seeded
    generator."""
    m = build_model(get_config(arch).reduced(**over), device="cpu")
    return m, m.init(torch.Generator().manual_seed(seed))


# ------------------------------------------------ twins of the reference's tests


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-3b"])
def test_serve_engine_continuous_batching(arch):
    m, params = _model(arch, 1)
    eng = ServeEngine(m, params, n_slots=2, max_len=64)
    reqs = [Request(prompt=[1, 2, 3], max_new_tokens=4, rid=i) for i in range(4)]
    out = eng.run(reqs)
    assert all(r.done for r in out)
    assert all(len(r.output) == 4 for r in out)


def test_serve_engine_matches_forward_greedy():
    """Greedy engine tokens == argmax over teacher-forced forward logits."""
    m, params = _model("qwen2-0.5b", 2, capacity_factor=8.0)
    prompt = [5, 9, 2, 7]
    eng = ServeEngine(m, params, n_slots=2, max_len=32)
    req = Request(prompt=prompt, max_new_tokens=3)
    eng.run([req])
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(3):
            logits, _ = m.forward(params, {"tokens": [toks]})
            toks.append(int(logits[0, -1].argmax()))
    assert req.output == toks[len(prompt):], (req.output, toks[len(prompt):])


def test_serve_engine_budget_one_stops_at_one_token():
    """max_new_tokens=1 yields exactly the prefill-sampled token and frees
    the slot at once."""
    m, params = _model("qwen2-0.5b", 1)
    eng = ServeEngine(m, params, n_slots=1, max_len=32)
    reqs = [Request(prompt=[1, 2, 3], max_new_tokens=1, rid=i) for i in range(3)]
    out = eng.run(reqs)
    assert all(r.done for r in out)
    assert [len(r.output) for r in out] == [1, 1, 1]
    assert eng.slot_req == [None]
    with torch.no_grad():
        logits, _ = m.forward(params, {"tokens": [[1, 2, 3]]})
    assert out[0].output == [int(logits[0, -1].argmax())]


def test_serve_engine_budget_one_leaves_cache_clean():
    """A max_new_tokens=1 request retires at admission without occupying a
    slot: the cache after it is exactly the cache before it, and a later
    request through the same slot decodes as on a fresh engine."""
    m, params = _model("qwen2-0.5b", 1)
    eng = ServeEngine(m, params, n_slots=1, max_len=32)
    before = [a.clone() for a in _leaves(eng.cache)]
    eng.run([Request(prompt=[1, 2, 3], max_new_tokens=1, rid=0)])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(eng.cache), before))
    req = Request(prompt=[4, 5], max_new_tokens=3, rid=1)
    eng.run([req])
    fresh = Request(prompt=[4, 5], max_new_tokens=3, rid=1)
    ServeEngine(m, params, n_slots=1, max_len=32).run([fresh])
    assert req.output == fresh.output


def test_serve_sampling_reproducible_across_admission_order():
    """Sampled tokens derive from (engine seed, rid, token index): the same
    request gets the same tokens whatever shares its batch and in whatever
    order admission happened; another engine seed changes them."""
    m, params = _model("qwen2-0.5b", 2)

    def serve(order, n_slots):
        reqs = [Request(prompt=[3 + r, 5, 2], max_new_tokens=4, temperature=0.8, rid=r)
                for r in order]
        ServeEngine(m, params, n_slots=n_slots, max_len=32, seed=7).run(reqs)
        return {r.rid: list(r.output) for r in reqs}

    a = serve([0, 1, 2, 3], n_slots=2)
    b = serve([3, 2, 1, 0], n_slots=1)
    assert a == b
    reqs = [Request(prompt=[3, 5, 2], max_new_tokens=4, temperature=0.8)]
    ServeEngine(m, params, n_slots=1, max_len=32, seed=8).run(reqs)
    assert any(list(reqs[0].output) != v for v in a.values())


# ------------------------------------------------ against the reference engine


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b", "rwkv6-3b"])
def test_greedy_tokens_match_reference_engine(arch):
    """Five requests of 1-5 prompt tokens through 2 slots (admissions while
    other slots decode, a recurrent family's rows restored): the port's
    greedy tokens equal the reference engine's on converted parameters."""
    jm = jbuild_model(jget_config(arch).reduced())
    jparams = jm.init(jax.random.PRNGKey(1))
    m = build_model(get_config(arch).reduced(), device="cpu")
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = [[1, 2, 3], [5, 9, 2, 7, 11], [4], [8, 8, 8, 8], [17, 3]]
    jr = [JRequest(prompt=p, max_new_tokens=5, rid=i) for i, p in enumerate(prompts)]
    tr = [Request(prompt=p, max_new_tokens=5, rid=i) for i, p in enumerate(prompts)]
    JServeEngine(jm, jparams, n_slots=2, max_len=32).run(jr)
    ServeEngine(m, params, n_slots=2, max_len=32).run(tr)
    assert [r.output for r in tr] == [r.output for r in jr]


# ------------------------------------------------ admission


def test_validation_reasons():
    m, params = _model("qwen2-0.5b", 1)
    eng = ServeEngine(m, params, n_slots=1, max_len=8)
    reqs = [Request(prompt=[]), Request(prompt=[1], max_new_tokens=0),
            Request(prompt=list(range(7))), Request(prompt=[1, 512]),
            Request(prompt=[1, 2], max_new_tokens=2)]
    eng.run(reqs)
    assert [r.reject_reason for r in reqs] == [
        "invalid:empty prompt", "invalid:max_new_tokens=0 < 1",
        "too_large:prompt of 7 tokens leaves no decode room under max_len=8",
        "invalid:token id outside [0, 512)", None]
    assert reqs[-1].done and len(reqs[-1].output) == 2 and not eng.use_graph


# ------------------------------------------------ the body the graph captures


@pytest.mark.parametrize("arch,over", [
    ("qwen2-0.5b", {}), ("qwen2-moe-a2.7b", {}), ("rwkv6-3b", {}), ("zamba2-2.7b", {}),
    ("qwen2-vl-72b", {}), ("whisper-base", {}), ("gemma-2b", {"kv_cache_dtype": "int8"})])
def test_decode_step_makes_no_host_round_trip(arch, over):
    """The CPU rehearsal of the capture: after a warm step, the engine's
    in-place decode step makes no tensor from host data, reads nothing back
    and sizes nothing by the data (each a blocking copy or a wait that a
    CUDA graph capture forbids on the card), and it gives the same logits
    and cache as outside the mode."""
    m, params = _model(arch, 0, **over)
    eng = ServeEngine(m, params, n_slots=2, max_len=16)
    assert eng.add_request(Request(prompt=[1, 2, 3], max_new_tokens=4))
    eng.step()
    snap = [a.clone() for a in _leaves(eng.cache)]
    want = eng._body()
    after = [a.clone() for a in _leaves(eng.cache)]
    for a, b in zip(_leaves(eng.cache), snap):
        a.copy_(b)
    with _NoHostRoundTrip():
        got = eng._body()
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(eng.cache), after))
