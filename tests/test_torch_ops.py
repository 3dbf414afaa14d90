"""The PyTorch port's plain ops against ``zig_gpt2_tpu.ops.layers`` on the
same numpy inputs (CPU).

Tolerances: the element-wise ops (layer_norm, gelu, softmax, embedding)
use ``tests.tolerance.assert_tensors_close``, the reference's per-op policy
(abs 5e-7 below 1e-3, else rel 6e-4); the ops with a reduction over a
matmul (linear, attention) use ``assert_logits_close`` (atol 1e-4,
rtol 2e-3), since torch and XLA sum in different orders. bf16 cases
compare after both round to bf16, within 2 bf16 ulps (rtol 1.6e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close, assert_tensors_close
from zig_gpt2_tpu.ops import layers as jops
from zig_gpt2_tpu_torch.ops import layers as tops


def _pair(a, dtype="f32"):
    if dtype == "bf16":
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def test_mask_value():
    assert tops.MASK_VALUE == jops.MASK_VALUE


@pytest.mark.parametrize("bias", [True, False])
def test_linear(rng, bias):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((48,)).astype(np.float32) if bias else None
    want = jops.linear(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = tops.linear(torch.from_numpy(x), torch.from_numpy(w),
                      None if b is None else torch.from_numpy(b))
    assert_logits_close(got.numpy(), np.asarray(want))


def test_embedding(rng):
    w = rng.standard_normal((50, 16)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = jops.embedding(jnp.asarray(idx), jnp.asarray(w))
    got = tops.embedding(torch.from_numpy(idx).long(), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm(rng, dtype):
    x = (rng.standard_normal((4, 9, 128)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal((128,)).astype(np.float32)
    b = rng.standard_normal((128,)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x, dtype), _pair(w, dtype), _pair(b, dtype)
    want = jops.layer_norm(jx, jw, jb, 1e-5)
    got = tops.layer_norm(tx, tw, tb, 1e-5)
    assert got.dtype == tx.dtype
    if dtype == "f32":
        assert_tensors_close(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1.6e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu(dtype):
    x = np.linspace(-10, 10, 4001, dtype=np.float32)
    jx, tx = _pair(x, dtype)
    want, got = jops.gelu(jx), tops.gelu(tx)
    if dtype == "f32":
        assert_tensors_close(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1.6e-2, atol=1e-6)


def test_softmax(rng):
    x = (rng.standard_normal((3, 4, 33)) * 5).astype(np.float32)
    for axis in (-1, 1):
        assert_tensors_close(tops.softmax(torch.from_numpy(x), axis).numpy(),
                             np.asarray(jops.softmax(jnp.asarray(x), axis)))


@pytest.mark.parametrize("masked", [False, True])
def test_causal_attention(rng, masked):
    B, H, T, D = 2, 3, 10, 32
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    lm = None
    if masked:
        lm = np.arange(T)[None, :] < np.array([[4], [10]])
    want = jops.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 length_mask=None if lm is None else jnp.asarray(lm))
    got = tops.causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                length_mask=None if lm is None else torch.from_numpy(lm))
    assert_logits_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [[3, 16], [1, 7], 5])
def test_decode_valid_mask(length):
    want = jops._decode_valid_mask(16, jnp.asarray(length, jnp.int32))
    got = tops.decode_valid_mask(16, torch.tensor(length, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention(rng, dtype):
    B, H, S, D = 2, 4, 24, 64
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    length = np.array([9, 24], np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(length))
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    if dtype == "f32":
        assert_logits_close(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1.6e-2, atol=1e-2)
