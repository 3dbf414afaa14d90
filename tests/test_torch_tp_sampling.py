"""The vocab-sharded draw (``runtime.sampling.sample_manual``) and the
per-rank index rules of ``parallel.shard_kernels``.

On a 1 x 4 mesh of CPU ranks (gloo, ``file://`` rendezvous, the model
group's two all-gathers per draw), logits (B=3, V=64) split 16 per rank:

- with the generator's seeds decorrelated per rank, the draw is the argmax
  of the concatenated per-shard perturbed logits (each shard's noise from
  the sampler's own Philox stream), plain and under top-k 20 (wider than a
  shard: the gate is the global width) and top-p 0.7, whose thresholds
  come from the all-gathered logits and equal the single-device ones;
- ties go to the lowest shard, greedy (equal maxima) and sampled (+inf
  logits, whose z* ties);
- every rank returns the same ids.

In one process: the seed decorrelation and the INT4 feature slices equal
the JAX package's (its ``shard_kernels`` under ``shard_map`` on the
conftest's virtual devices), and the lm_head masks phantom vocab by global
id on every rank's slice, so that no draw can reach an id >= vocab_size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu.parallel import shard_kernels as jsk
from zig_gpt2_tpu_torch.config import GPTConfig, RankConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.ops.layers import MASK_VALUE
from zig_gpt2_tpu_torch.ops.sampling_kernel import gumbel_noise
from zig_gpt2_tpu_torch.parallel.distributed import Collectives
from zig_gpt2_tpu_torch.parallel.shard_kernels import (combine_shards, decorrelate_seeds,
                                                       int4_row_shard_slices)
from zig_gpt2_tpu_torch.runtime.sampling import _SEED_HIGH, _threshold

TP, B, V = 4, 3, 64
VL = V // TP
G = torch.Generator().manual_seed(0)
LOGITS = torch.randn(B, V, generator=G) * 3
TIES = torch.randn(B, V, generator=G)
TIES[:, 1 * VL + 5] = TIES[:, 3 * VL + 2] = 50.0  # equal maxima on shards 1 and 3
INF = torch.randn(B, V, generator=G)
INF[:, 0 * VL + 7] = INF[:, 2 * VL + 3] = torch.inf  # z* = +inf on shards 0 and 2
DRAWS = 4
# name -> (logits, temperature, top_k, top_p)
CASES = {
    "plain": (LOGITS, 0.9, None, None),
    "top-k-20": (LOGITS, 0.8, 20, None),
    "top-p-0.7": (LOGITS, 0.8, None, 0.7),
    "greedy-tie": (TIES, 0.0, None, None),
    "sampled-inf-tie": (INF, 1.0, None, None),
}


def _expected(logits, temperature, top_k, top_p, seed):
    """The argmax of the concatenated per-shard perturbed logits, each
    shard's noise drawn as its rank draws it, ``DRAWS`` times."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(DRAWS):
        if temperature == 0.0:
            out.append(logits.argmax(-1).tolist())
            continue
        seeds = torch.randint(0, _SEED_HIGH, (B,), generator=gen, dtype=torch.int32)
        z = torch.cat([logits[:, w * VL:(w + 1) * VL] * np.float32(1 / temperature)
                       + gumbel_noise(decorrelate_seeds(seeds, w), VL) for w in range(TP)], -1)
        thresh = _threshold(logits, temperature, top_k, top_p)
        if thresh is not None:
            z = z.masked_fill(logits < thresh[:, None], -torch.inf)
        out.append(z.argmax(-1).tolist())
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [{"name": name, "kind": "sample", "logits": logits.numpy(), "temperature": t,
              "top_k": k, "top_p": p, "seed": 11, "draws": DRAWS}
             for name, (logits, t, k, p) in CASES.items()]
    return spawn_ranks(1, TP, cases, tmp_path_factory.mktemp("tp_sampling"))()


@pytest.mark.parametrize("name", list(CASES))
def test_sample_manual_is_the_argmax_over_shards(ranks, name):
    logits, t, k, p = CASES[name]
    want = _expected(logits, t, k, p, 11)
    for r in ranks:
        assert r[name]["ids"] == want


def test_ties_go_to_the_lowest_shard(ranks):
    assert ranks[0]["greedy-tie"]["ids"][0] == [1 * VL + 5] * B
    assert all(ids == [0 * VL + 7] * B for ids in ranks[0]["sampled-inf-tie"]["ids"])


def test_truncated_draws_stay_in_the_support(ranks):
    """Top-k 20 keeps ids of four shards' logits (more than one shard
    holds): every draw is among the row's 20 largest logits."""
    top = LOGITS.topk(20, -1).indices
    for ids in ranks[0]["top-k-20"]["ids"]:
        assert all(i in top[b].tolist() for b, i in enumerate(ids))
    assert len({i // VL for ids in ranks[0]["top-k-20"]["ids"] for i in ids}) > 1


def test_model_group_collectives(ranks):
    """Two all-gathers per draw, one more per thresholded draw; greedy
    draws gather too (z and ids)."""
    draws = len(CASES) * DRAWS
    assert ranks[0]["_collectives"]["model"] == {"all_gather": 2 * draws + 2 * DRAWS}


@pytest.mark.parametrize("w", range(8))
def test_seed_decorrelation_equals_jax(w):
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (16,), generator=G, dtype=torch.int32)
    want = np.asarray(jnp.asarray(seeds.numpy()) ^ ((w + 1) * jnp.int32(-1640531527)))
    np.testing.assert_array_equal(decorrelate_seeds(seeds, w).numpy(), want)


def test_combine_shards_ties_and_offsets():
    z = torch.tensor([[1.0, 5.0], [5.0, 5.0], [2.0, 4.0]])  # (tp=3, B=2)
    idx = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32)
    assert combine_shards(z, idx, 10).tolist() == [12, 1]


@pytest.mark.parametrize("tp,grouped", [(2, True), (4, True), (4, False)])
def test_int4_row_shard_slices_equal_jax(tp, grouped):
    """Each shard's two half-split feature ranges of x (rows, K) and of the
    grouped scales (K/G, N), against the JAX function under shard_map."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from zig_gpt2_tpu.parallel.mesh import make_mesh

    k, n, groups = 64, 8, (8 if grouped else 1)
    x = np.random.default_rng(tp).standard_normal((3, k)).astype(np.float32)
    scale = np.random.default_rng(9).standard_normal((groups, n)).astype(np.float32)
    mesh = make_mesh(1, tp, devices=jax.devices()[:tp])
    fn = shard_map(lambda a, s: jsk.int4_row_shard_slices(a, s, tp, "model"), mesh=mesh,
                   in_specs=(P(), P()), out_specs=(P(None, "model"), P("model", None)),
                   check_vma=False)
    jx, js = (np.asarray(a) for a in fn(jnp.asarray(x), jnp.asarray(scale)))
    for i in range(tp):
        px, ps = int4_row_shard_slices(torch.from_numpy(x), torch.from_numpy(scale), tp, i)
        np.testing.assert_array_equal(px.numpy(), jx[:, i * k // tp:(i + 1) * k // tp])
        sg = groups // tp if grouped else 1
        np.testing.assert_array_equal(ps.numpy(), js[i * sg:(i + 1) * sg])


@pytest.mark.parametrize("index", range(4))
def test_lm_head_masks_phantom_vocab_by_global_id(index):
    """Vocab 200 padded to 256 over 4 ranks: rank i's 64 logits mask exactly
    its global ids >= 200 (all of rank 3's last 56)."""
    cfg = GPTConfig(vocab_size=200, padded_vocab_size=256, context_size=8, n_layers=1,
                    n_heads=2, n_embed=8)
    local = RankConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(GPTConfig)},
                       model_group=Collectives(range(4), index, "cpu"))
    wte = torch.randn(64, 8, generator=G)
    logits = gpt2._lm_head({"wte": wte}, torch.randn(2, 8, generator=G), local)
    ids = torch.arange(index * 64, (index + 1) * 64)
    assert ((logits == MASK_VALUE).all(0) == (ids >= 200)).all()
    assert not (logits[:, ids < 200] == MASK_VALUE).any()
