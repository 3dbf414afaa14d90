"""Tensor-parallel serving of the port on a 1 x 2 mesh of CPU ranks (gloo,
``file://`` rendezvous) against the JAX package's step-level mesh engine
(``ZG2_STEP_SPMD=1``) on two virtual CPU devices, GPT2_NANO at tp=2:
float f32, INT8, INT4 with an INT8 KV cache, and w8a8. Every case holds

- the greedy tokens identical to the JAX mesh engine's;
- the teacher-forced logits of the first prompt (prefill, then each
  decode step) within ``tests/tolerance.py``'s end-to-end gate: the JAX
  reference reads them from its per-shard decode body (``torch_tp_ref``);
- the greedy tokens equal to the port's single-device engine on the same
  weights, or parted only at a near-tie of its logits (the rule
  ``chip_smoke.py`` uses);
- both ranks returning the same tokens.

The collective form of this file is the model group: the embedding's and
each row-parallel linear's all-reduce, the INT4 all-gather, and the
sampler's two all-gathers. The ranks start once for the module
(``torch_tp_worker.spawn_ranks``).
"""

import dataclasses

import pytest
import torch

from tests.tolerance import E2E_ATOL, E2E_RTOL, assert_logits_close
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import (env, first_divergence, make_mesh, mesh_logits, port_config,
                                to_port)
from tests.torch_tp_ref import tree as jax_tree
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine

TP = 2
PROMPTS = [[1, 2, 3, 4], [100, 7, 300]]
STEPS = 10
# name: (weights mode, KV cache, w8a8)
CASES = {
    "float-f32": (None, None, False),
    "int8": ("int8", None, False),
    "int4-kv8": ("int4", "int8", False),
    "w8a8": ("int8", None, True),
}
# The sampled requests of the float case: temperature, top-k, top-p.
SAMPLED = [dict(temperature=0.8, seed=1), dict(temperature=0.8, top_k=40, top_p=0.9, seed=2)]
# Near-tie rule against the single-device engine (a divergence is allowed
# only where its top two logits lie within this).
NEAR_TIE = 1e-3


def _case_tree(name):
    mode, kv, w8a8 = CASES[name]
    params, cfg = jax_tree(GPT2_NANO, mode, TP, group_size=16 if mode == "int4" else None)
    if w8a8:
        cfg = dataclasses.replace(cfg, act_quant=True)
    return params, cfg, kv


@pytest.fixture(scope="module")
def trees():
    return {name: _case_tree(name) for name in CASES}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """(each rank's results, the JAX references): the ranks run while the
    JAX mesh engines compile and serve."""
    tmp = tmp_path_factory.mktemp("tp_engine")
    cases = []
    for name, (params, cfg, kv) in trees.items():
        path = str(tmp / f"{name}.pt")
        torch.save(to_port(params), path)
        cases.append({"name": name, "kind": "engine", "params": path, "config": port_config(cfg),
                      "engine": dict(max_seq=32, prompt_buckets=(8,), kv_quant=kv),
                      "prompts": PROMPTS, "steps": STEPS, "logits": True,
                      "sampled": SAMPLED if name == "float-f32" else ()})
    join = spawn_ranks(1, TP, cases, tmp)
    ref = {}
    with env(ZG2_STEP_SPMD="1", ZG2_FUSED_ATTN="interpret"):
        for name, (params, cfg, kv) in trees.items():
            eng = JEngine(cfg, params, max_seq=32, prompt_buckets=(8,), kv_quant=kv,
                          mesh=make_mesh(1, TP))
            toks = [eng.generate(ids, STEPS, JSampling(temperature=0.0)) for ids in PROMPTS]
            ref[name] = {"tokens": toks, "logits": mesh_logits(eng, PROMPTS[0], toks[0])}
    return join(), ref


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_identical_to_jax_mesh_engine(ranks, jax_ref, name):
    assert ranks[0][name]["tokens"] == jax_ref[name]["tokens"]
    assert len(set(map(tuple, ranks[0][name]["tokens"]))) > 1  # the streams vary


@pytest.mark.parametrize("name", list(CASES))
def test_per_step_logits_within_tolerance(ranks, jax_ref, name):
    """Prefill and each teacher-forced decode step: atol 1e-4 + rtol 2e-3
    (``tolerance.E2E_ATOL``, ``E2E_RTOL``), phantom vocab included."""
    got, want = ranks[0][name]["logits"], jax_ref[name]["logits"]
    assert got.shape == want.shape == (STEPS + 1, 512)
    assert_logits_close(got, want, E2E_ATOL, E2E_RTOL, msg=name)


def _port_logits(eng, ids, tokens):
    """The single-device engine's teacher-forced logits: prefill, then one
    decode step per token."""
    prompt = torch.zeros((1, 8), dtype=torch.int32)
    prompt[0, :len(ids)] = torch.tensor(ids)
    cache, logits = gpt2.prefill(eng.params, eng.new_cache(), prompt, torch.tensor([len(ids)]),
                                 eng.config)
    rows = [logits]
    for t in tokens:
        cache, logits = gpt2.decode_step(eng.params, cache, torch.tensor([t]), eng.config)
        rows.append(logits)
    return torch.cat(rows).float().numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_matches_single_device_port(ranks, trees, name):
    """Tokens equal to the single-device engine's, or parted where its top
    two logits lie within max(NEAR_TIE, 3 x floor): floor the largest gap
    between the two programs' teacher-forced logits on the TP stream.
    Under w8a8 the programs differ by design (a decode step quantizes each
    row over the rank's K, as the JAX step-level body does), so its floor is
    that gap, not roundoff."""
    params, cfg, kv = trees[name]
    eng = InferenceEngine(tconfig.GPTConfig(**port_config(cfg)), to_port(params), max_seq=32,
                          prompt_buckets=(8,), kv_quant=kv, device="cpu")
    tp_tokens = ranks[0][name]["tokens"]
    floor = float(abs(ranks[0][name]["logits"]
                      - _port_logits(eng, PROMPTS[0], tp_tokens[0])).max())
    tol = max(NEAR_TIE, 3 * floor)
    if not cfg.act_quant:
        assert floor < 1e-4, floor
    for ids, got in zip(PROMPTS, tp_tokens):
        want = eng.generate(ids, STEPS, SamplingConfig(temperature=0.0))
        i = first_divergence(got, want)
        if i is not None:
            top2 = torch.from_numpy(_port_logits(eng, ids, want[:i])[-1]).topk(2).values
            assert float(top2[0] - top2[1]) < tol, (name, ids, i, got, want, floor)


def test_ranks_return_the_same_tokens(ranks):
    for name in CASES:
        assert ranks[1][name]["tokens"] == ranks[0][name]["tokens"], name
        assert ranks[1][name]["sampled"] == ranks[0][name]["sampled"], name


def test_sampled_requests_in_vocab_and_reproducible(ranks, trees):
    """T=0.8, and T=0.8 with top-k 40 and top-p 0.9 (a threshold from the
    all-gathered logits): full budgets, no phantom id, and the two
    requests differ."""
    sampled = ranks[0]["float-f32"]["sampled"]
    assert [len(s) for s in sampled] == [STEPS] * len(SAMPLED)
    assert all(0 <= t < GPT2_NANO.vocab_size for s in sampled for t in s)
    assert sampled[0] != sampled[1]


def test_collectives_per_step(ranks):
    """Each rank's model group ran the collectives the steps imply. Per
    forward (a prefill or a decode step): one all-reduce for the embedding
    and one per row-parallel linear (two per layer; w8a8's whole-row
    prefill reduces its integer sums instead, the same count), and for
    INT4 one all-gather of x per row-parallel linear (w8a8's prefill
    likewise). Per draw: two all-gathers (z* and the ids), and one more
    for a top-k / top-p threshold. One gather of each teacher-forced
    logits window."""
    L = GPT2_NANO.n_layers
    reduces = gathers = 0
    for name, (mode, _, w8a8) in CASES.items():
        requests = len(PROMPTS) + (len(SAMPLED) if name == "float-f32" else 0)
        forwards = requests * (1 + STEPS) + (1 + STEPS)  # generate, then teacher-forced
        reduces += forwards * (1 + 2 * L)
        gathers += 2 * requests * (1 + STEPS) + 1
        if mode == "int4":
            gathers += forwards * 2 * L
        if w8a8:
            gathers += (requests + 1) * 2 * L  # one prefill per request, one teacher-forced
    gathers += 1 + STEPS  # the top-k / top-p request's thresholds
    for r in ranks:
        assert r["_collectives"]["model"] == {"all_reduce": reduces, "all_gather": gathers}
