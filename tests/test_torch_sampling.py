"""The port's sampling against the JAX package (CPU).

The JAX kernel draws from the TPU's hardware PRNG, which has no CPU
lowering and no counterpart elsewhere, so sampled ids are held by law (a
chi-square test against softmax(logits / T)); greedy ids and the top-k /
top-p thresholds are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from zig_gpt2_tpu.runtime import sampling as jsamp
from zig_gpt2_tpu_torch.ops import sampling_kernel as sk
from zig_gpt2_tpu_torch.runtime import sampling as tsamp


def test_philox_known_answer():
    """Random123's Philox4x32-10 known answer at counter 0, key 0."""
    z = torch.zeros(1, dtype=torch.int64)
    assert int(sk.philox_x0(z, z, z)) == 0x6627E8D5


def test_greedy_equals_jnp_argmax(rng):
    logits = rng.standard_normal((5, 300)).astype(np.float32)
    logits[2, [7, 90]] = 9.0  # a tie: the first index wins in both
    got = tsamp.sample(torch.from_numpy(logits), None, temperature=0.0)
    want = jnp.argmax(jnp.asarray(logits), axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got[2]) == 7


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9), (20, 0.5), (1, None),
                                         (None, 0.01)])
def test_thresholds_match_jax_mask(rng, top_k, top_p):
    """The kept set (logit >= threshold) equals the support the JAX
    package's _mask_logits leaves finite."""
    logits = (rng.standard_normal((4, 257)) * 2).astype(np.float32)
    T = 0.8
    thresh = tsamp._threshold(torch.from_numpy(logits), T, top_k, top_p)
    kept = logits >= thresh.numpy()[:, None]
    jmasked = jsamp._mask_logits(jnp.asarray(logits) / T, top_k, top_p)
    np.testing.assert_array_equal(kept, np.isfinite(np.asarray(jmasked)))
    tm = tsamp._mask_logits(torch.from_numpy(logits) / T, top_k, top_p)
    np.testing.assert_array_equal(torch.isfinite(tm).numpy(), kept)


def test_no_threshold_without_truncation(rng):
    logits = torch.from_numpy(rng.standard_normal((2, 10)).astype(np.float32))
    assert tsamp._threshold(logits, 1.0, None, None) is None
    assert tsamp._threshold(logits, 1.0, 10, 1.0) is None


@pytest.mark.parametrize("T", [0.7, 1.5])
def test_sampler_distribution_chi_square(T):
    """Many rows of the same small-V logits, one independent Philox stream
    per row: the id histogram fits softmax(logits / T)."""
    V, n = 12, 24000
    logits = np.linspace(-2.0, 2.0, V, dtype=np.float32)
    x = torch.from_numpy(np.tile(logits, (n, 1)))
    seeds = torch.from_numpy(np.random.default_rng(5).integers(0, 2**31 - 1, n).astype(np.int32))
    ids = sk.sample_categorical(x, seeds, T).numpy()
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits) / T), np.float64)
    p /= p.sum()
    counts = np.bincount(ids, minlength=V)
    _, pval = stats.chisquare(counts, p * n)
    assert pval > 1e-3, (counts, p * n)


def test_sampler_respects_threshold():
    V, n = 10, 4000
    logits = torch.arange(V, dtype=torch.float32).repeat(n, 1)
    seeds = torch.arange(n, dtype=torch.int32)
    thresh = torch.full((n,), 7.0)
    ids = sk.sample_categorical(logits, seeds, 2.0, thresh)
    assert ids.min() >= 7 and set(ids.tolist()) == {7, 8, 9}


def test_tie_break_smallest_id():
    """Two +inf logits give two equal z (+inf whatever the noise): the
    smaller id wins, on every seed."""
    logits = torch.full((3, 8), -1.0)
    logits[:, 2] = float("inf")
    logits[:, 5] = float("inf")
    ids = sk.sample_categorical(logits, torch.tensor([1, 2, 3], dtype=torch.int32), 1.0)
    assert ids.tolist() == [2, 2, 2]


def test_deterministic_per_seed(rng):
    logits = torch.from_numpy(rng.standard_normal((4, 1000)).astype(np.float32))
    s1 = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    a = sk.sample_categorical(logits, s1, 0.9)
    b = sk.sample_categorical(logits, s1.clone(), 0.9)
    assert torch.equal(a, b)
    draws = {tuple(sk.sample_categorical(logits, s1 + k, 0.9).tolist()) for k in range(6)}
    assert len(draws) > 1
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(tsamp.sample(logits, g1, 0.9, 50, 0.95),
                       tsamp.sample(logits, g2, 0.9, 50, 0.95))


def test_bf16_logits_read_as_f32(rng):
    logits = torch.from_numpy(rng.standard_normal((3, 500)).astype(np.float32)).to(torch.bfloat16)
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert torch.equal(sk.sample_categorical(logits, seeds, 0.8),
                       sk.sample_categorical(logits.float(), seeds, 0.8))


# --- return_max: the winning z* (the JAX kernel's ``return_max``) -------------

@pytest.mark.parametrize("thresh", [False, True], ids=["all", "top-k"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_return_max_is_the_z_of_the_returned_id(rng, dtype, thresh):
    """z* equals logit_id * (1/T) + g_id of the returned id, recomputed from
    ``gumbel_noise``, bit for bit, and is the row's largest kept z; the ids
    are the same with and without the flag."""
    T = 0.7
    logits = torch.from_numpy((rng.standard_normal((6, 3000)) * 2).astype(np.float32)).to(dtype)
    seeds = torch.from_numpy(rng.integers(0, 2**31 - 1, 6).astype(np.int32))
    th = logits.float().topk(50, -1).values[:, -1].contiguous() if thresh else None
    ids, zmax = sk.sample_categorical(logits, seeds, T, th, return_max=True)
    assert zmax.dtype == torch.float32 and zmax.shape == (6,)
    assert torch.equal(ids, sk.sample_categorical(logits, seeds, T, th))
    x = logits.float()
    inv_t = torch.tensor(np.float32(1.0 / T))
    z = x * inv_t + sk.gumbel_noise(seeds, x.shape[1])
    z_ids = z.gather(1, ids.long()[:, None])[:, 0]
    assert torch.equal(zmax, z_ids)
    if th is not None:
        z = z.masked_fill(x < th[:, None], -float("inf"))
    assert torch.equal(zmax, z.amax(-1))


def test_return_max_masked_ids_never_win():
    """Ids 0-31 sit just below the threshold, ids 32-63 on it: without the
    mask about half the rows' largest z is a masked id. With it, no masked
    id wins and z* is the z of a kept id."""
    V, n = 64, 400
    logits = torch.zeros(n, V)
    logits[:, :32] = -1e-3
    thresh = torch.zeros(n)
    seeds = torch.arange(n, dtype=torch.int32)
    ids, zmax = sk.sample_categorical(logits, seeds, 1.0, thresh, return_max=True)
    z = logits + sk.gumbel_noise(seeds, V)
    assert (z.argmax(-1) < 32).float().mean() > 0.3  # the mask matters
    assert ids.min() >= 32
    assert torch.equal(zmax, z.gather(1, ids.long()[:, None])[:, 0])
    assert torch.equal(zmax, z[:, 32:].amax(-1))


def test_return_max_ties_keep_the_smallest_id():
    logits = torch.full((3, 8), -1.0)
    logits[:, 2] = logits[:, 5] = float("inf")
    ids, zmax = sk.sample_categorical(logits, torch.tensor([1, 2, 3], dtype=torch.int32),
                                      1.0, return_max=True)
    assert ids.tolist() == [2, 2, 2] and torch.isinf(zmax).all()
