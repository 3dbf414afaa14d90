"""The port's continuous batcher over a mesh of CPU ranks (gloo,
``file://`` rendezvous) against the JAX batcher over the same mesh shape
of virtual CPU devices with ``ZG2_STEP_SPMD=1``: six greedy requests of
mixed prompt lengths and budgets through two slots, GPT2_NANO.

- 1 x 2: the ring cache with float and INT8 rows, a linear cache
  (``ZG2_RING=0``), and two decode steps per host sync;
- 2 x 1: one slot per data rank (each rank prefills the admissions that
  land in its slots; the step's token block is gathered over the data
  group), ring cache.

Every request's tokens equal the JAX batcher's, and every rank's
bookkeeping ends with the same tokens. One group of ranks per mesh
shape, started once for the module.
"""

import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import env, make_mesh, port_config, to_port
from tests.torch_tp_ref import tree as jax_tree
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher

REQUESTS = [([1, 2, 3], 6), ([4, 5], 9), ([6, 7, 8, 9], 5), ([300, 3], 8), ([11], 7),
            ([12, 13, 14, 15, 16], 6)]
# name -> (mesh (dp, tp), KV cache, ZG2_RING, decode_chunk)
CASES = {
    "1x2-ring-float": ((1, 2), None, "1", 1),
    "1x2-ring-int8": ((1, 2), "int8", "1", 1),
    "1x2-linear-float-chunk2": ((1, 2), None, "0", 2),
    "2x1-ring-float": ((2, 1), None, "1", 1),
}
SHAPES = sorted({c[0] for c in CASES.values()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({mesh shape: each rank's results}, {case: JAX tokens per rid})."""
    params, cfg = jax_tree(GPT2_NANO, None, 2)
    joins = {}
    for shape in SHAPES:
        tmp = tmp_path_factory.mktemp(f"tp_batcher_{shape[0]}x{shape[1]}")
        path = str(tmp / "nano.pt")
        torch.save(to_port(params), path)
        cases = [{"name": name, "kind": "batcher", "params": path, "config": port_config(cfg),
                  "env": {"ZG2_RING": ring},
                  "batcher": dict(batch_size=2, max_seq=32, prompt_buckets=(8,), kv_quant=kv,
                                  decode_chunk=chunk),
                  "requests": REQUESTS}
                 for name, (s, kv, ring, chunk) in CASES.items() if s == shape]
        joins[shape] = spawn_ranks(*shape, cases, tmp)
    ref = {}
    for name, ((dp, tp), kv, ring, chunk) in CASES.items():
        with env(ZG2_STEP_SPMD="1", ZG2_FUSED_ATTN="interpret", ZG2_RING=ring):
            b = JBatcher(cfg, params, batch_size=2, max_seq=32, prompt_buckets=(8,),
                         kv_quant=kv, decode_chunk=chunk,
                         sampling=JSampling(temperature=0.0), mesh=make_mesh(dp, tp))
            assert b.config.ring_cache == (ring == "1")
            for ids, budget in REQUESTS:
                b.submit(ids, budget)
            ref[name] = {r.rid: r.generated for r in b.run()}
    return {shape: join() for shape, join in joins.items()}, ref


@pytest.mark.parametrize("name", list(CASES))
def test_batcher_tokens_identical_to_jax_mesh_batcher(runs, name):
    ranks, ref = runs
    shape, _, ring, _ = CASES[name]
    for r in ranks[shape]:
        assert r[name]["tokens"] == ref[name]
        assert r[name]["ring"] == (ring == "1") and not r[name]["kv_packed"]
    assert [len(ref[name][i]) for i in range(len(REQUESTS))] == [b for _, b in REQUESTS]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_batcher_stays_eager(runs, name):
    """No rank's batcher builds or captures a decode graph, and none would
    on a card: gloo's collectives are staged through the host."""
    shape = CASES[name][0]
    for r in runs[0][shape]:
        assert r[name]["decode_graph"] == {"built": False, "captures": 0, "on_card": False}
