"""Prefix caching under a mesh: the port's engine at 1 x 2 and its
continuous batcher at 2 x 2 (ring cache) over CPU ranks (gloo, ``file://``
rendezvous), each with a registered prefix, against the JAX package's
engine and batcher over the same mesh of virtual CPU devices with the same
prefix registered (``ZG2_STEP_SPMD=1``; ``ZG2_FUSED_ATTN=interpret`` for
INT8 caches), GPT2_NANO padded for tp=2, greedy:

- engine: f32 weights with an f32 and with a bf16 cache
  (``cache_dtype``); prompts that hold the whole prefix, part of it, and
  none of it;
- batcher: four slots (two per data rank), f32 weights with an f32 cache
  and INT4 weights with an INT8 KV cache, six requests of which four hit
  (one of them partly).

Every stream equals the JAX one on every rank, and the prefix rows reused
(the engine's ``prefix_tokens_reused``, the batcher's ``prefix_hits`` and
``prefill_tokens_saved``) are the JAX runtime's. Each rank stores the
prefix rows of its own heads, the same on both data ranks. Four ranks,
started once for the module (``torch_tp_worker.spawn_ranks``).
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import env, make_mesh, port_config, to_port
from tests.torch_tp_ref import tree as jax_tree
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu.runtime.engine import GenerationMetrics as JMetrics
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine

TP = 2
PREFIX = [5, 6, 7, 8, 9, 10]
PROMPTS = [PREFIX + [11, 12], PREFIX[:3] + [40, 41], [100, 7, 300]]
STEPS = 8
REQUESTS = [(PREFIX + [11], 6), (PREFIX + [20, 21], 5), ([1, 2, 3], 6),
            (PREFIX[:4] + [30], 7), (PREFIX + [11], 4), ([300, 3], 5)]
# name: (weights mode, KV cache, cache dtype)
ENGINE = {
    "float-f32": (None, None, None),
    "float-bf16-cache": (None, None, "bf16"),
}
# name: (weights mode, KV cache)
BATCHER = {"ring-float": (None, None), "ring-int4-kv8": ("int4", "int8")}
TORCH_DTYPE = {None: None, "bf16": torch.bfloat16}
JAX_DTYPE = {None: None, "bf16": jnp.bfloat16}
KW = dict(max_seq=32, prompt_buckets=(8,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, {case: JAX results})."""
    tmp = tmp_path_factory.mktemp("tp_prefix")
    trees = {mode: jax_tree(GPT2_NANO, mode, TP, group_size=16 if mode else None)
             for mode in (None, "int4")}
    for mode, (params, _) in trees.items():
        torch.save(to_port(params), str(tmp / f"{mode}.pt"))
    cases = [{"name": f"engine-{name}", "kind": "engine", "params": str(tmp / f"{mode}.pt"),
              "mesh": [1, TP], "config": port_config(trees[mode][1]), "prefixes": [PREFIX],
              "engine": dict(KW, kv_quant=kv, cache_dtype=TORCH_DTYPE[dt]),
              "prompts": PROMPTS, "steps": STEPS}
             for name, (mode, kv, dt) in ENGINE.items()]
    cases += [{"name": f"batcher-{name}", "kind": "batcher", "params": str(tmp / f"{mode}.pt"),
               "config": port_config(trees[mode][1]), "env": {"ZG2_RING": "1"},
               "prefixes": [PREFIX], "batcher": dict(KW, batch_size=4, kv_quant=kv),
               "requests": REQUESTS}
              for name, (mode, kv) in BATCHER.items()]
    join = spawn_ranks(2, TP, cases, tmp)
    ref = {}
    greedy = JSampling(temperature=0.0)
    with env(ZG2_STEP_SPMD="1", ZG2_FUSED_ATTN="interpret", ZG2_RING="1"):
        for name, (mode, kv, dt) in ENGINE.items():
            params, cfg = trees[mode]
            eng = JEngine(cfg, params, kv_quant=kv, cache_dtype=JAX_DTYPE[dt],
                          mesh=make_mesh(1, TP), **KW)
            eng.register_prefix(PREFIX)
            out = ref[f"engine-{name}"] = {"tokens": [], "reused": []}
            for ids in PROMPTS:
                m = JMetrics()
                out["tokens"].append(eng.generate(ids, STEPS, greedy, metrics=m))
                out["reused"].append(m.prefix_tokens_reused)
        for name, (mode, kv) in BATCHER.items():
            params, cfg = trees[mode]
            b = JBatcher(cfg, params, batch_size=4, kv_quant=kv, sampling=greedy,
                         mesh=make_mesh(2, TP), **KW)
            b.register_prefix(PREFIX)
            for ids, budget in REQUESTS:
                b.submit(ids, budget)
            ref[f"batcher-{name}"] = {"tokens": {r.rid: r.generated for r in b.run()},
                                      "metrics": dataclasses.asdict(b.metrics)}
    return join(), ref


@pytest.mark.parametrize("name", list(ENGINE))
def test_mesh_engine_prefix_tokens_identical_to_jax(runs, name):
    ranks, ref = runs
    case = f"engine-{name}"
    want = ref[case]
    assert want["reused"] == [6, 3, 0]
    for r in ranks:  # both data rows serve the 1 x 2 engine
        assert r[case]["tokens"] == want["tokens"]
        assert r[case]["reused"] == want["reused"]
    assert len(set(map(tuple, want["tokens"]))) > 1


@pytest.mark.parametrize("name", list(BATCHER))
def test_mesh_batcher_prefix_tokens_and_hits_identical_to_jax(runs, name):
    ranks, ref = runs
    case = f"batcher-{name}"
    want = ref[case]
    assert [len(want["tokens"][i]) for i in range(len(REQUESTS))] == [b for _, b in REQUESTS]
    for r in ranks:
        assert r[case]["tokens"] == want["tokens"] and r[case]["ring"]
        for key in ("prefix_hits", "prefill_tokens_saved"):
            assert r[case]["metrics"][key] == want["metrics"][key], key
    assert want["metrics"]["prefix_hits"] == 4
    assert want["metrics"]["prefill_tokens_saved"] == 6 + 6 + 4 + 6
