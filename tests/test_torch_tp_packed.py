"""The head-pair-packed KV cache under tensor parallelism, CPU ranks (gloo,
``file://`` rendezvous) against the JAX step-level mesh engine and
batcher (``ZG2_STEP_SPMD=1``, ``ZG2_FUSED_ATTN=interpret``: its packed
kernels per shard), both with ``ZG2_KV_PACKED=1``. A config of four heads
of 64:

- 1 x 2: two heads per rank, even, so the layout stays packed (pairs never
  straddle ranks): the engine with a float and with an INT8 cache (one
  scale per pair) and the ring batcher, greedy tokens identical to the JAX
  package's and teacher-forced logits within ``tests/tolerance.py``'s
  end-to-end gate;
- 1 x 4: one head per rank, odd, so both packages fall back to the
  unpacked layout (no phantom head under a mesh), tokens identical.

One group of ranks per mesh shape, started once for the module.
"""

import pytest
import torch

from tests.tolerance import E2E_ATOL, E2E_RTOL, assert_logits_close
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import env, make_mesh, mesh_logits, port_config, to_port
from tests.torch_tp_ref import tree as jax_tree
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.config import GPTConfig, SamplingConfig as JSampling
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine

PACK_CFG = GPTConfig(vocab_size=512, context_size=128, n_layers=2, n_heads=4, n_embed=256)
PROMPTS = [[7, 3, 5], [2, 9, 4, 100]]
STEPS = 8
REQUESTS = [([1, 2, 3], 6), ([4, 5], 7), ([6, 7, 8, 9], 5), ([300, 3], 6)]
ENV = {"ZG2_KV_PACKED": "1"}
# name -> (tp, kind, KV cache, packed)
CASES = {
    "tp2-float": (2, "engine", None, True),
    "tp2-int8": (2, "engine", "int8", True),
    "tp2-ring-batcher": (2, "batcher", None, True),
    "tp4-odd-float": (4, "engine", None, False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, cfg = jax_tree(PACK_CFG, None, 4, seed=3)
    joins = {}
    for tp in (2, 4):
        tmp = tmp_path_factory.mktemp(f"tp_packed_{tp}")
        path = str(tmp / "packcfg.pt")
        torch.save(to_port(params), path)
        cases = []
        for name, (t, kind, kv, _) in CASES.items():
            if t != tp:
                continue
            case = {"name": name, "kind": kind, "params": path, "config": port_config(cfg),
                    "env": ENV}
            if kind == "engine":
                case.update(engine=dict(max_seq=32, prompt_buckets=(8,), kv_quant=kv),
                            prompts=PROMPTS, steps=STEPS, logits=True)
            else:
                case.update(batcher=dict(batch_size=2, max_seq=32, prompt_buckets=(8,),
                                         kv_quant=kv), requests=REQUESTS)
            cases.append(case)
        joins[tp] = spawn_ranks(1, tp, cases, tmp)
    ref = {}
    with env(ZG2_STEP_SPMD="1", ZG2_FUSED_ATTN="interpret", **ENV):
        for name, (tp, kind, kv, packed) in CASES.items():
            kw = dict(max_seq=32, prompt_buckets=(8,), kv_quant=kv, mesh=make_mesh(1, tp))
            if kind == "engine":
                eng = JEngine(cfg, params, **kw)
                assert eng.config.kv_packed == packed
                toks = [eng.generate(ids, STEPS, JSampling(temperature=0.0)) for ids in PROMPTS]
                ref[name] = {"tokens": toks, "logits": mesh_logits(eng, PROMPTS[0], toks[0])}
            else:
                b = JBatcher(cfg, params, batch_size=2, sampling=JSampling(temperature=0.0),
                             **kw)
                assert b.config.kv_packed == packed and b.config.ring_cache
                for ids, budget in REQUESTS:
                    b.submit(ids, budget)
                ref[name] = {"tokens": {r.rid: r.generated for r in b.run()}}
    return {tp: join() for tp, join in joins.items()}, ref


@pytest.mark.parametrize("name", list(CASES))
def test_packed_tokens_identical_to_jax(runs, name):
    ranks, ref = runs
    tp, _, _, packed = CASES[name]
    for r in ranks[tp]:
        assert r[name]["tokens"] == ref[name]["tokens"]
        assert r[name]["kv_packed"] == packed


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[1] == "engine"])
def test_packed_logits_within_tolerance(runs, name):
    """atol 1e-4 + rtol 2e-3 (``tolerance.E2E_ATOL``, ``E2E_RTOL``)."""
    ranks, ref = runs
    assert_logits_close(ranks[CASES[name][0]][0][name]["logits"], ref[name]["logits"],
                        E2E_ATOL, E2E_RTOL, msg=name)
