"""The port's INT8-cache pieces against the JAX package: ``quantize_kv``,
and the plain version (which the CPU runs) of the INT8 deferred decode
attention against the Pallas kernel ``decode_attention_quant_deferred_fused``
in interpret mode.

Tolerances: ``quantize_kv`` is compared for equality (both divide and round
half to even in f32). Attention f32 atol/rtol 1e-5: the same f32 online
softmax in another order, as in ``tests/test_torch_attention.py``; bf16 q
compares the bf16 outputs within two bf16 ulps (rtol 1.6e-2, atol 1e-2),
since each rounds its f32 result once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_gpt2_tpu.ops import attention as jatt
from zig_gpt2_tpu.ops import layers as jops
from zig_gpt2_tpu_torch.ops import attention as tatt
from zig_gpt2_tpu_torch.ops import layers as tops

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1.6e-2, atol=1e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(rng, L, B, H, S, D):
    """q (B, H, D) f32; the current rows quantized; int8 caches with
    positive f32 scale planes."""
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, ks_n = jops.quantize_kv(jnp.asarray(rng.standard_normal((B, H, D)), jnp.float32))
    vn, vs_n = jops.quantize_kv(jnp.asarray(rng.standard_normal((B, H, D)), jnp.float32))
    kc, vc = (rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random((L, B, H, S)) * 0.02 + 1e-3).astype(np.float32) for _ in range(2))
    return [q, *map(np.array, (kn, ks_n, vn, vs_n)), kc, ks, vc, vs]


def _torch(arrs, dtype="f32"):
    t = [torch.from_numpy(np.array(a)) for a in arrs]
    t[0] = t[0].to(TDT[dtype])
    return t


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 4, 16), (5, 8, 32)], ids=["B2xH4xD16", "B5xH8xD32"])
def test_quantize_kv_bit_equal(rng, dtype, shape):
    """Per-(token, head) absmax / 127; a zero row keeps a finite scale."""
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 1] = 0.0
    jq, js = jops.quantize_kv(jnp.asarray(x).astype(JDT[dtype]))
    tq, ts = tops.quantize_kv(torch.from_numpy(x).to(TDT[dtype]))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layer", [0, 2])
def test_quant_deferred_matches_pallas_kernel(rng, dtype, layer):
    """Stacked INT8 cache, B=4 with mixed lengths including 0 and S-1, an
    odd head count (as 1.5B's 25)."""
    L, B, H, S, D = 3, 4, 3, 32, 64
    arrs = _inputs(rng, L, B, H, S, D)
    length = np.array([0, 1, 17, S - 1], np.int32)
    j = [jnp.asarray(a) for a in arrs]
    j[0] = j[0].astype(JDT[dtype])
    want = jatt.decode_attention_quant_deferred_fused(
        *j, jnp.asarray(length), layer=jnp.int32(layer), interpret=True)
    got = tatt.decode_attention_quant_deferred(*_torch(arrs, dtype), torch.from_numpy(length),
                                               layer=layer)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("D", [32, 64])
def test_quant_deferred_equals_append_then_attend(rng, D):
    """Attending over length old rows + the quantized self-term equals
    appending that row (values and scales) at index length and attending
    over length + 1 rows with the Pallas kernel's appended-cache variant."""
    L, B, H, S = 2, 3, 4, 16
    q, kn, ksn, vn, vsn, kc, ks, vc, vs = _inputs(rng, L, B, H, S, D)
    length = np.array([0, 6, 15], np.int32)
    layer = 1
    got = tatt.decode_attention_quant_deferred(
        *_torch([q, kn, ksn, vn, vsn, kc, ks, vc, vs]), torch.from_numpy(length), layer=layer)
    for b, n in enumerate(length):
        kc[layer, b, :, n], vc[layer, b, :, n] = kn[b], vn[b]
        ks[layer, b, :, n], vs[layer, b, :, n] = ksn[b], vsn[b]
    want = jatt.decode_attention_quant_fused(
        *map(jnp.asarray, (q, kc, ks, vc, vs)), jnp.asarray(length + 1),
        layer=jnp.int32(layer), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])


def test_quant_deferred_ignores_rows_past_length(rng):
    """Stale rows at or past length never reach the result, NaN scales
    included."""
    L, B, H, S, D = 1, 2, 2, 8, 32
    arrs = _inputs(rng, L, B, H, S, D)
    length = torch.tensor([3, 0], dtype=torch.int32)
    clean = tatt.decode_attention_quant_deferred(*_torch(arrs), length, layer=0)
    kc, ks, vc, vs = arrs[5:]
    kc[0, 0, :, 3:] = 127
    vc[0, 0, :, 3:] = -127
    ks[0, 0, :, 3:] = np.nan
    vs[0, 0, :, 3:] = np.nan
    ks[0, 1] = np.nan
    vs[0, 1] = np.nan
    dirty = tatt.decode_attention_quant_deferred(*_torch(arrs), length, layer=0)
    np.testing.assert_array_equal(dirty.numpy(), clean.numpy())
    # length 0: the self-term alone, i.e. the dequantized v_new.
    vn, vsn = arrs[3], arrs[4]
    np.testing.assert_allclose(dirty[1].numpy(), vn[1] * vsn[1][:, None], rtol=1e-6, atol=1e-6)


def test_quant_wrapper_rejects_unsupported_device():
    q = torch.zeros(1, 1, 32, device="meta")
    i8 = torch.zeros(1, 1, 32, dtype=torch.int8, device="meta")
    s = torch.zeros(1, 1, device="meta")
    c = torch.zeros(1, 1, 1, 4, 32, dtype=torch.int8, device="meta")
    p = torch.zeros(1, 1, 1, 4, device="meta")
    with pytest.raises(ValueError):
        tatt.decode_attention_quant_deferred(q, i8, s, i8, s, c, p, c, p,
                                             torch.zeros(1, dtype=torch.int32), layer=0)
