"""Prompt-lookup speculative serving under a mesh: the port's continuous
batcher with ``speculative="ngram"``, ``spec_k=4``, over CPU ranks (gloo,
``file://`` rendezvous), against the JAX batcher with the same settings
over the same mesh of virtual CPU devices (its op-level GSPMD program),
GPT2_NANO padded for tp=2, four slots:

- greedy at 1 x 2 (each data row of the spawn serves it, on its model
  group) and 2 x 2, f32 weights and INT4 with an INT8 KV cache: every
  request's tokens and the batcher's ``tokens_per_round`` equal the JAX
  batcher's, on every rank;
- sampled (T=0.8, top-k 40) at 2 x 2: every rank commits the same tokens
  (each model group gathers its verify logits and keeps one generator in
  step, so its ranks take the same accept counts);
- auto-off at 2 x 2 under w8a8 (``spec_min_tpr`` above the k + 1 ceiling,
  so it fires at the first full window; two rounds per sync, so that the
  window of eight syncs can hold its 64 slot-rounds): the switch to plain decode comes
  at the JAX batcher's step, and the tokens after it, whose decode steps
  quantize each w8a8 row over its whole K (the op-level program,
  ``op_level``), equal the JAX batcher's.

Four ranks, started once for the module (``torch_tp_worker.spawn_ranks``).
"""

import dataclasses

import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import env, make_mesh, port_config, to_port
from tests.torch_tp_ref import tree as jax_tree
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher

TP = 2
K = 4
REQUESTS = [([1, 2, 3, 1, 2, 3, 1, 2], 12), ([4, 5, 4, 5, 4], 10), ([6, 7, 8, 9], 9),
            ([300, 3, 300, 3], 12), ([11, 12, 11], 8), ([40, 41, 42, 40, 41], 11)]
LONG = [([i, i + 1, i + 2, i, i + 1], 40) for i in range(20, 60, 10)]
# name: (mesh, weights mode, KV cache, sampling, requests, spec_min_tpr, max_seq)
CASES = {
    "1x2-float": ((1, TP), None, None, None, REQUESTS, 1.5, 32),
    "1x2-int4-kv8": ((1, TP), "int4", "int8", None, REQUESTS, 1.5, 32),
    "2x2-float": ((2, TP), None, None, None, REQUESTS, 1.5, 32),
    "2x2-int4-kv8": ((2, TP), "int4", "int8", None, REQUESTS, 1.5, 32),
    "2x2-sampled": ((2, TP), None, None, dict(temperature=0.8, top_k=40, seed=5), REQUESTS,
                    1.5, 32),
    "2x2-w8a8-auto-off": ((2, TP), "w8a8", None, None, LONG, K + 2.0, 64),
}
GREEDY = [n for n, c in CASES.items() if c[3] is None]


def _tree(mode):
    params, cfg = jax_tree(GPT2_NANO, "int8" if mode == "w8a8" else mode, TP,
                           group_size=16 if mode == "int4" else None)
    if mode == "w8a8":
        cfg = dataclasses.replace(cfg, act_quant=True)
    return params, cfg


def _batcher_kw(case):
    _, _, kv, _, _, tpr, max_seq = CASES[case]
    return dict(batch_size=4, max_seq=max_seq, prompt_buckets=(8,), kv_quant=kv,
                speculative="ngram", spec_k=K, spec_min_tpr=tpr, spec_chunk=1 if tpr < K else 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, {greedy case: JAX tokens and metrics})."""
    tmp = tmp_path_factory.mktemp("tp_spec")
    trees = {mode: _tree(mode) for mode in {c[1] for c in CASES.values()}}
    for mode, (params, _) in trees.items():
        torch.save(to_port(params), str(tmp / f"{mode}.pt"))
    cases = [{"name": name, "kind": "batcher", "params": str(tmp / f"{mode}.pt"),
              "mesh": list(shape), "config": port_config(trees[mode][1]),
              "sampling": sampling or {"temperature": 0.0}, "batcher": _batcher_kw(name),
              "requests": reqs}
             for name, (shape, mode, _, sampling, reqs, _, _) in CASES.items()]
    join = spawn_ranks(2, TP, cases, tmp)
    ref = {}
    with env(ZG2_FUSED_ATTN="interpret"):
        for name in GREEDY:
            shape, mode, _, _, reqs, _, _ = CASES[name]
            params, cfg = trees[mode]
            b = JBatcher(cfg, params, sampling=JSampling(temperature=0.0),
                         mesh=make_mesh(*shape), **_batcher_kw(name))
            for ids, budget in reqs:
                b.submit(ids, budget)
            ref[name] = {"tokens": {r.rid: r.generated for r in b.run()},
                         "tokens_per_round": b.metrics.tokens_per_round,
                         "spec_auto_off_step": b.metrics.spec_auto_off_step}
    return join(), ref


@pytest.mark.parametrize("name", GREEDY)
def test_mesh_spec_greedy_tokens_identical_to_jax(runs, name):
    ranks, ref = runs
    want = ref[name]
    reqs = CASES[name][4]
    assert [len(want["tokens"][i]) for i in range(len(reqs))] == [b for _, b in reqs]
    for r in ranks:
        assert r[name]["tokens"] == want["tokens"]
        assert not r[name]["kv_packed"] and r[name]["op_level"]


@pytest.mark.parametrize("name", GREEDY)
def test_mesh_spec_tokens_per_round_equal_to_jax(runs, name):
    ranks, ref = runs
    for r in ranks:
        assert r[name]["metrics"]["tokens_per_round"] == ref[name]["tokens_per_round"]
        assert r[name]["metrics"]["spec_auto_off_step"] == ref[name]["spec_auto_off_step"]
    if name != "2x2-w8a8-auto-off":
        assert ref[name]["tokens_per_round"] > 1.0 and ref[name]["spec_auto_off_step"] is None


def test_mesh_spec_sampled_ranks_commit_the_same_tokens(runs):
    ranks, _ = runs
    name = "2x2-sampled"
    got = [r[name]["tokens"] for r in ranks]
    assert all(g == got[0] for g in got[1:])
    assert sorted(len(t) for t in got[0].values()) == sorted(b for _, b in REQUESTS)
    assert all(0 <= t < GPT2_NANO.vocab_size for toks in got[0].values() for t in toks)
    assert ranks[0][name]["metrics"]["spec_rounds"] > 0


def test_mesh_spec_auto_off_switches_to_plain_decode(runs):
    """The switch fires once the window holds 64 slot-rounds, at the JAX
    batcher's step, and plain decode then serves the rest."""
    ranks, ref = runs
    name = "2x2-w8a8-auto-off"
    step = ref[name]["spec_auto_off_step"]
    assert step is not None and 0 < step < ranks[0][name]["metrics"]["steps"]
    for r in ranks:
        assert r[name]["metrics"]["spec_auto_off_step"] == step
