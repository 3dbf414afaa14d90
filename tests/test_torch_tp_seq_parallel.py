"""Sequence-parallel prefill of the port over CPU ranks (gloo, ``file://``
rendezvous) against the port's plain tensor-parallel prefill and the JAX
package's ``gpt2.prefill`` with ``seq_parallel=True`` on the same mesh of
virtual CPU devices, GPT2_NANO padded for tp=2: float f32, INT4 with an
INT8 KV cache, and w8a8.

One (4, 15) batch of ragged lengths (15, 12, 10, 2), as
``tests/test_sharding.py``'s sequence-parallel test has them, with T=15 not
a multiple of tp: the port pads T to 16 under the length mask. At 1 x 2
(each data row of the spawn serves it, on its model group) and 2 x 2:

- the logits and every cache leaf are bit-equal to the plain
  tensor-parallel prefill on every rank (a sum of two is the same either
  way round);
- the logits (vocab and lanes gathered) and the float cache lie within
  ``tests/tolerance.py``'s end-to-end gate of the JAX mesh prefill;
- one prefill's model-group collectives: 1 + 2L reduce-scatters and 2L + 1
  all-gathers (plus the INT4 and w8a8 x gathers), against plain TP's
  1 + 2L all-reduces.

Four ranks, started once for the module (``torch_tp_worker.spawn_ranks``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import E2E_ATOL, E2E_RTOL, assert_logits_close
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import make_mesh, port_config, to_port
from tests.torch_tp_ref import tree as jax_tree
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.config import GPT2_NANO
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.parallel import mesh as jmesh

TP = 2
B, T = 4, 15
LENGTHS = [15, 12, 10, 2]
ROWS = 32
# name: (weights mode, KV cache, w8a8)
TREES = {
    "float-f32": (None, None, False),
    "int4-kv8": ("int4", "int8", False),
    "w8a8": ("int8", None, True),
}
SHAPES = [(1, TP), (2, TP)]
CASES = {f"{dp}x{tp}-{name}": (dp, tp, name) for dp, tp in SHAPES for name in TREES}


def _tree(name):
    mode, _, w8a8 = TREES[name]
    params, cfg = jax_tree(GPT2_NANO, mode, TP, group_size=16 if mode == "int4" else None)
    if w8a8:
        cfg = dataclasses.replace(cfg, act_quant=True)
    return params, cfg


def _tokens():
    return np.random.default_rng(7).integers(0, GPT2_NANO.vocab_size, (B, T)).astype(np.int32)


def _jax_prefill(params, cfg, dp, tp, kv):
    """The JAX mesh prefill with ``seq_parallel=True``: (logits, cache)."""
    mesh = make_mesh(dp, tp)
    cfg = dataclasses.replace(cfg, mesh=mesh, spmd=True, seq_parallel=True)
    placed = jax.device_put(params, jmesh.param_shardings(mesh, cfg, params))
    cache = jax.device_put(jgpt2.init_kv_cache(cfg, B, ROWS, quant=kv),
                           jmesh.cache_shardings(mesh, cfg, quant=kv))
    data = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(jmesh.DATA_AXIS))
    cache, logits = jax.jit(lambda p, c, t, n: jgpt2.prefill(p, c, t, n, cfg))(
        placed, cache, jax.device_put(jnp.asarray(_tokens()), data),
        jax.device_put(jnp.asarray(LENGTHS, jnp.int32), data))
    return np.asarray(logits, np.float32), jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, {case: JAX (logits, cache)})."""
    tmp = tmp_path_factory.mktemp("tp_seq_parallel")
    trees = {name: _tree(name) for name in TREES}
    for name, (params, _) in trees.items():
        torch.save(to_port(params), str(tmp / f"{name}.pt"))
    cases = [{"name": case, "kind": "prefill", "params": str(tmp / f"{name}.pt"),
              "mesh": [dp, tp], "config": port_config(trees[name][1]), "tokens": _tokens(),
              "lengths": LENGTHS, "rows": ROWS, "kv_quant": TREES[name][1]}
             for case, (dp, tp, name) in CASES.items()]
    join = spawn_ranks(2, TP, cases, tmp)
    ref = {case: _jax_prefill(*trees[name], dp, tp, TREES[name][1])
           for case, (dp, tp, name) in CASES.items()}
    return join(), ref


@pytest.mark.parametrize("case", list(CASES))
def test_seq_parallel_bit_equal_to_plain_tp(runs, case):
    ranks, _ = runs
    for r in ranks:
        assert all(r[case]["bit_equal"].values()), r[case]["bit_equal"]
        assert set(r[case]["bit_equal"]) >= {"k", "v", "length", "logits"}


@pytest.mark.parametrize("case", list(CASES))
def test_seq_parallel_logits_and_cache_within_tolerance_of_jax(runs, case):
    """Logits over the whole padded vocab, and the float cache (heads from
    the model ranks, lanes from the data ranks): atol 1e-4 + rtol 2e-3
    (``tolerance.E2E_ATOL``, ``E2E_RTOL``). The INT8 cache's rows round
    to whole int8 steps, so its logits carry the check."""
    ranks, ref = runs
    dp, tp, name = CASES[case]
    want_logits, want_cache = ref[case]
    got = ranks[0][case]["sp"]["logits"]
    assert got.shape == want_logits.shape == (B, 512)
    assert_logits_close(got, want_logits, E2E_ATOL, E2E_RTOL, msg=case)
    if TREES[name][1] is None:
        for key in ("k", "v"):  # (L, B / dp, H / tp, S, D) per rank
            whole = np.concatenate([np.concatenate([ranks[d * tp + m][case]["sp"]["cache"][key]
                                                    for m in range(tp)], axis=2)
                                    for d in range(dp)], axis=1)
            assert_logits_close(whole, want_cache[key], E2E_ATOL, E2E_RTOL, msg=f"{case} {key}")
    lengths = np.concatenate([ranks[d * tp][case]["sp"]["cache"]["length"] for d in range(dp)])
    assert lengths.tolist() == LENGTHS


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_scatters_per_prefill(runs, case):
    """Sequence parallelism swaps each all-reduce of the plain prefill (the
    embedding's and two per layer) for a reduce-scatter, and adds an
    all-gather before each column-parallel stage (two per layer) and one
    before the lm_head."""
    ranks, _ = runs
    L = GPT2_NANO.n_layers
    int4 = TREES[CASES[case][2]][0] == "int4"
    w8a8 = TREES[CASES[case][2]][2]
    extra = 2 * L if int4 or w8a8 else 0  # the row linears' gathers of x over K
    for r in ranks:
        plain, sp = r[case]["plain"]["collectives"], r[case]["sp"]["collectives"]
        assert plain == {"all_reduce": 1 + 2 * L, **({"all_gather": extra} if extra else {})}
        assert sp == {"reduce_scatter": 1 + 2 * L, "all_gather": 2 * L + 1 + extra}
