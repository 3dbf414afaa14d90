"""The port's mesh shapes beyond 1 x 2 on CPU ranks (gloo, ``file://``
rendezvous) against the JAX step-level mesh engine (``ZG2_STEP_SPMD=1``)
on the same shape of virtual CPU devices:

- 2 x 1, data parallel only: ``generate_scan`` over B=2 lanes, one per data
  rank (the data group's all-gather of the token block), greedy tokens
  identical to the JAX engine's; sampled lanes on identical prompts draw
  independent noise (the data index folded into the seed) and a seed
  reproduces its stream;
- 1 x 4: GPT2_NANO INT4 (groups of 16 aligned for tp=4) with an INT8 KV
  cache, and GPT2_MICRO float (one head of 64 per rank: odd, so
  unpacked), greedy tokens identical and teacher-forced logits within
  ``tests/tolerance.py``'s end-to-end gate.

One group of ranks per mesh shape, started once for the module.
"""

import numpy as np
import pytest
import torch

from tests.tolerance import E2E_ATOL, E2E_RTOL, assert_logits_close
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import env, make_mesh, mesh_logits, port_config, to_port
from tests.torch_tp_ref import tree as jax_tree
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.config import GPT2_MICRO, GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine

PROMPTS = np.zeros((2, 8), np.int32)
PROMPTS[:, :4] = [[1, 2, 3, 4], [9, 300, 7, 5]]
SAME = np.zeros((2, 8), np.int32)
SAME[:, :3] = [5, 6, 7]  # identical lanes: identical logits on both data ranks
STEPS = 8
SAMPLED = dict(temperature=1.2, seed=5)
# 1 x 4 cases: name -> (config, weights mode, KV cache)
TP4 = {"nano-int4-kv8": (GPT2_NANO, "int4", "int8"), "micro-float": (GPT2_MICRO, None, None)}
TP4_PROMPTS = [[1, 2, 3, 4], [100, 7, 300]]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """(ranks, JAX greedy tokens) of the 2 x 1 mesh."""
    tmp = tmp_path_factory.mktemp("tp_dp2")
    params, cfg = jax_tree(GPT2_NANO, None, 1)
    path = str(tmp / "nano.pt")
    torch.save(to_port(params), path)
    engine = dict(batch_size=2, max_seq=32, prompt_buckets=(8,))
    cases = [{"name": "scan", "kind": "scan", "params": path, "config": port_config(cfg),
              "engine": engine, "prompts": PROMPTS.tolist(), "lengths": [4, 4],
              "steps": STEPS, "sampling": [dict(temperature=0.0)]},
             {"name": "same", "kind": "scan", "params": path, "config": port_config(cfg),
              "engine": engine, "prompts": SAME.tolist(), "lengths": [3, 3], "steps": STEPS,
              "sampling": [SAMPLED, SAMPLED, dict(SAMPLED, seed=6)]}]
    join = spawn_ranks(2, 1, cases, tmp)
    with env(ZG2_STEP_SPMD="1"):
        eng = JEngine(cfg, params, max_seq=32, prompt_buckets=(8,), batch_size=2,
                      mesh=make_mesh(2, 1))
        want = eng.generate_scan(PROMPTS, [4, 4], STEPS, JSampling(temperature=0.0))
    return join(), want


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    """(ranks, {case: (JAX tokens, JAX logits)}) of the 1 x 4 mesh."""
    tmp = tmp_path_factory.mktemp("tp_tp4")
    trees = {name: jax_tree(cfg, mode, 4, group_size=16 if mode == "int4" else None)
             for name, (cfg, mode, _) in TP4.items()}
    cases = []
    for name, (params, cfg) in trees.items():
        path = str(tmp / f"{name}.pt")
        torch.save(to_port(params), path)
        cases.append({"name": name, "kind": "engine", "params": path,
                      "config": port_config(cfg), "env": {"ZG2_KV_PACKED": "auto"},
                      "engine": dict(max_seq=32, prompt_buckets=(8,), kv_quant=TP4[name][2]),
                      "prompts": TP4_PROMPTS, "steps": STEPS, "logits": True})
    join = spawn_ranks(1, 4, cases, tmp)
    ref = {}
    with env(ZG2_STEP_SPMD="1", ZG2_FUSED_ATTN="interpret"):
        for name, (params, cfg) in trees.items():
            eng = JEngine(cfg, params, max_seq=32, prompt_buckets=(8,), kv_quant=TP4[name][2],
                          mesh=make_mesh(1, 4))
            assert not eng.config.kv_packed
            toks = [eng.generate(ids, STEPS, JSampling(temperature=0.0)) for ids in TP4_PROMPTS]
            ref[name] = (toks, mesh_logits(eng, TP4_PROMPTS[0], toks[0]))
    return join(), ref


def test_dp2_greedy_scan_identical_to_jax(dp2):
    ranks, want = dp2
    for r in ranks:  # every rank returns both lanes
        np.testing.assert_array_equal(np.asarray(r["scan"]["tokens"][0]), want)
    assert not np.array_equal(want[0], want[1])


def test_dp2_data_ranks_draw_independent_noise(dp2):
    """Identical prompts on the two data ranks: the sampled lanes differ
    (each data rank's seed is folded with its index), the same seed gives
    the same tokens again, another seed others."""
    ranks, _ = dp2
    first, again, other = (np.asarray(t) for t in ranks[0]["same"]["tokens"])
    assert not np.array_equal(first[0], first[1])
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)
    assert ranks[1]["same"]["tokens"] == ranks[0]["same"]["tokens"]


def test_dp2_collectives_on_the_data_group(dp2):
    """tp=1: the model group has one rank and communicates nothing; the
    data group gathers each call's token block once."""
    ranks, _ = dp2
    for r in ranks:
        assert r["_collectives"] == {"model": {}, "data": {"all_gather": 4}}


@pytest.mark.parametrize("name", list(TP4))
def test_tp4_greedy_tokens_identical_to_jax(tp4, name):
    ranks, ref = tp4
    for r in ranks:
        assert r[name]["tokens"] == ref[name][0]
    assert not ranks[0][name]["kv_packed"] and ranks[0][name]["heads"] == 1


@pytest.mark.parametrize("name", list(TP4))
def test_tp4_per_step_logits_within_tolerance(tp4, name):
    """atol 1e-4 + rtol 2e-3 (``tolerance.E2E_ATOL``, ``E2E_RTOL``)."""
    ranks, ref = tp4
    assert_logits_close(ranks[0][name]["logits"], ref[name][1], E2E_ATOL, E2E_RTOL, msg=name)
