"""The port's ring KV cache against the JAX package (CPU): the ring plain
versions of the deferred decode attention (which the CPU runs) against the
Pallas kernels ``decode_attention[_quant]_deferred_fused(..., start=)`` in
interpret mode, and the ring ``decode_step`` against the JAX model's.

A lane's valid rows are the interval [start, start + length) mod S. A cache
holding a linear cache's rows rotated by start must attend identically.

Tolerances: attention f32 atol/rtol 1e-5 (the same f32 online softmax in
another order) and bf16 two bf16 ulps (rtol 1.6e-2, atol 1e-2), as in
``tests/test_torch_attention.py``, also for the ring plain version
against the linear plain version on rotated caches (the same rows, summed
over S in another order; on the card the kernels are held to bit
equality, since they walk the rows in one logical order). Model logits
and float cache rows: ``assert_logits_close``. INT8 cache rows: equal
(both packages quantize the same way); their scales, absmax / 127 of K/V
projections that agree to roundoff: ``assert_logits_close``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close
from zig_gpt2_tpu.config import GPT2_NANO
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.ops import attention as jatt
from zig_gpt2_tpu.ops import layers as jops
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.ops import attention as tatt
from zig_gpt2_tpu_torch.ops import layers as tops
from zig_gpt2_tpu_torch.weights import params_from_numpy, params_to_numpy

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1.6e-2, atol=1e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
L, B, H, LAYER = 2, 3, 2, 1


def _starts_lengths(S):
    """Three (start, length) assignments over B=3 lanes: starts 0, mid and
    S-1 against lengths 0, 1 and S-1 in each rotation (the intervals from
    mid and S-1 with length S-1 wrap)."""
    starts = np.array([0, S // 2, S - 1], np.int32)
    lengths = [0, 1, S - 1]
    return [(starts, np.array(lengths[r:] + lengths[:r], np.int32)) for r in range(3)]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _float_inputs(rng, S, D):
    q, kn, vn = (rng.standard_normal((B, H, D)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.standard_normal((L, B, H, S, D)).astype(np.float32) for _ in range(2))
    return [q, kn, vn, kc, vc]


def _int8_inputs(rng, S, D):
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, ks_n = jops.quantize_kv(jnp.asarray(rng.standard_normal((B, H, D)), jnp.float32))
    vn, vs_n = jops.quantize_kv(jnp.asarray(rng.standard_normal((B, H, D)), jnp.float32))
    kc, vc = (rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random((L, B, H, S)) * 0.02 + 1e-3).astype(np.float32) for _ in range(2))
    return [q, *map(np.array, (kn, ks_n, vn, vs_n)), kc, ks, vc, vs]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [24, 21])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_deferred_matches_pallas_kernel(rng, dtype, S, D):
    arrs = _float_inputs(rng, S, D)
    jargs = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    targs = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    for start, length in _starts_lengths(S):
        want = jatt.decode_attention_deferred_fused(
            *jargs, jnp.asarray(length), layer=jnp.int32(LAYER), interpret=True,
            start=jnp.asarray(start))
        got = tatt.decode_attention_deferred(*targs, torch.from_numpy(length), layer=LAYER,
                                             start=torch.from_numpy(start))
        assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype],
                                   err_msg=f"start={start} length={length}")


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [24, 21])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_quant_deferred_matches_pallas_kernel(rng, dtype, S, D):
    arrs = _int8_inputs(rng, S, D)
    jargs = [jnp.asarray(a) for a in arrs]
    jargs[0] = jargs[0].astype(JDT[dtype])
    targs = [torch.from_numpy(a) for a in arrs]
    targs[0] = targs[0].to(TDT[dtype])
    for start, length in _starts_lengths(S):
        want = jatt.decode_attention_quant_deferred_fused(
            *jargs, jnp.asarray(length), layer=jnp.int32(LAYER), interpret=True,
            start=jnp.asarray(start))
        got = tatt.decode_attention_quant_deferred(*targs, torch.from_numpy(length),
                                                   layer=LAYER,
                                                   start=torch.from_numpy(start))
        assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype],
                                   err_msg=f"start={start} length={length}")


def _rotate(a, starts, s_axis):
    """Each lane b (axis 1) of a stacked cache rolled by starts[b] on its S
    axis: linear row i lands at ring row (starts[b] + i) mod S."""
    out = a.copy()
    for b, st in enumerate(starts):
        out[:, b] = np.roll(a[:, b], st, axis=s_axis - 1)
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("S", [24, 21])
def test_ring_equals_linear_on_rotated_cache(rng, quant, S):
    """The ring plain version over caches rotated by start equals the
    linear plain version over the unrotated caches, and NaN in every row
    outside the intervals does not reach it."""
    D = 32
    arrs = _int8_inputs(rng, S, D) if quant else _float_inputs(rng, S, D)
    fn = tatt.decode_attention_quant_deferred if quant else tatt.decode_attention_deferred
    caches = range(5, 9) if quant else range(3, 5)
    for start, length in _starts_lengths(S):
        want = fn(*map(torch.from_numpy, arrs), torch.from_numpy(length), layer=LAYER)
        ring = list(arrs)
        for i in caches:
            ring[i] = _rotate(arrs[i], start, arrs[i].ndim - 1 if arrs[i].ndim == 4
                              else arrs[i].ndim - 2)
            if ring[i].dtype == np.float32:  # poison the rows outside each interval
                for b in range(B):
                    outside = (np.arange(S) - start[b]) % S >= length[b]
                    ring[i][:, b, :, outside] = np.nan
        got = fn(*map(torch.from_numpy, ring), torch.from_numpy(length), layer=LAYER,
                 start=torch.from_numpy(start))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["f32"])


@pytest.mark.parametrize("length", [[3, 16, 0], [16, 1, 15]])
def test_decode_valid_mask_ring(length):
    start = np.array([0, 9, 15], np.int32)
    want = jops._decode_valid_mask(16, jnp.asarray(length, jnp.int32), jnp.asarray(start))
    got = tops.decode_valid_mask(16, torch.tensor(length, dtype=torch.int32),
                                 torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_wrapper_validates_start():
    q = torch.zeros(2, 2, 32, device="meta")
    c = torch.zeros(1, 2, 2, 8, 32, device="meta")
    with pytest.raises(ValueError):
        tatt.decode_attention_deferred(q, q, q, c, c, torch.zeros(2, dtype=torch.int32),
                                       layer=0, start=torch.zeros(2, dtype=torch.int32))


# --- the ring decode_step against the JAX model ----------------------------

RING_NANO = dataclasses.replace(GPT2_NANO, ring_cache=True)


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_ring_decode_step_matches_jax(monkeypatch, rng, kv_quant):
    """A ring cache with random rows, lanes at divergent starts and
    lengths, the write row two below the end: four steps cross the wrap.
    Logits match step by step; start, wptr and length are equal; the rows
    and scales inside each lane's interval are equal."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")  # the JAX model's kernel path
    jp = jgpt2.init_params(RING_NANO, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    R = 10
    jc = jax.tree.map(np.asarray, jgpt2.init_kv_cache(RING_NANO, 2, R, quant=kv_quant))
    for name in ("k", "v"):
        if kv_quant:
            jc[name] = rng.integers(-127, 128, jc[name].shape).astype(np.int8)
            jc[name + "_scale"] = (rng.random(jc[name + "_scale"].shape) * 0.05
                                   + 1e-3).astype(np.float32)
        else:
            jc[name] = rng.standard_normal(jc[name].shape).astype(np.float32)
    jc["start"] = np.array([3, 7], np.int32)
    jc["length"] = np.array([5, 3], np.int32)  # both intervals end at R - 2
    jc["wptr"] = np.array(R - 2, np.int32)
    tc = params_from_numpy(jc)
    assert tc["wptr"].shape == () and tc["start"].dtype == torch.int32
    jc = jax.tree.map(jnp.asarray, jc)
    tcfg = _tcfg(RING_NANO)
    for step in range(4):
        toks = rng.integers(0, GPT2_NANO.vocab_size, (2,)).astype(np.int32)
        jc, jl = jgpt2.decode_step(jp, jc, jnp.asarray(toks), RING_NANO)
        tc, tl = tgpt2.decode_step(tp, tc, torch.from_numpy(toks), tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg=f"step {step}")
    got, want = params_to_numpy(tc), jax.tree.map(np.asarray, jc)
    assert int(got["wptr"]) == int(want["wptr"]) == 2  # wrapped
    for name in ("start", "length"):
        np.testing.assert_array_equal(got[name], want[name])
    for b in range(2):
        rows = (want["start"][b] + np.arange(want["length"][b])) % R
        for name in (("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v")):
            if got[name].dtype == np.int8:
                np.testing.assert_array_equal(got[name][:, b][:, :, rows],
                                              want[name][:, b][:, :, rows], err_msg=name)
            else:
                assert_logits_close(got[name][:, b][:, :, rows],
                                    want[name][:, b][:, :, rows], msg=name)


def test_ring_cache_leaves_and_linear_override():
    cache = tgpt2.init_kv_cache(_tcfg(RING_NANO), 3, 12, quant="int8")
    assert cache["start"].shape == (3,) and cache["start"].dtype == torch.int32
    assert cache["wptr"].shape == () and cache["wptr"].dtype == torch.int32
    linear = tgpt2.init_kv_cache(_tcfg(RING_NANO), 3, 12, ring=False)
    assert "start" not in linear and "wptr" not in linear
    jax_keys = set(jgpt2.init_kv_cache(RING_NANO, 3, 12, quant="int8"))
    assert set(cache) == jax_keys


def test_bridge_carries_ring_cache():
    """A JAX ring INT8 cache crosses the weight bridge and back with every
    leaf in its own dtype, even when float leaves are cast: int8 rows, f32
    scale planes, int32 length and start, the 0-d int32 wptr."""
    jc = jax.tree.map(np.asarray, jgpt2.init_kv_cache(RING_NANO, 2, 8, quant="int8"))
    jc["wptr"] = np.array(5, np.int32)
    tc = params_from_numpy(jc, dtype=torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    back = params_to_numpy(tc)
    assert int(back["wptr"]) == 5 and back["wptr"].shape == ()
    for k, v in jc.items():
        np.testing.assert_array_equal(back[k], v)
