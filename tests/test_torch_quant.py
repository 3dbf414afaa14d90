"""The port's weight quantization and the plain version of its dequant-GEMV
kernel (which the CPU runs) against the JAX package.

Tolerances: quantized values, scales, the INT4 unpack and the dequantized
weights are compared for equality: both packages divide, round half to
even and multiply in f32, element for element. The GEMV and the linears
are held at the JAX package's own 2e-5 (``tests/test_quant.py``): the same
f32 products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_gpt2_tpu.config import GPT2_NANO
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import kernels as jkernels
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu_torch.quant import kernels as tkernels
from zig_gpt2_tpu_torch.quant import quantize as tq
from zig_gpt2_tpu_torch.weights import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
# K of every linear of the four GPT-2 sizes (E and 4E).
GPT2_KS = [768, 3072, 1024, 4096, 1280, 5120, 1600, 6400]


def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _t(a):
    """A writable torch copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _both(p):
    """Quantized dict of either package -> dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_pick_group_size_matches_jax(mode):
    for k in GPT2_KS + [128, 256, 320, 512]:
        assert tq.pick_group_size(k, mode) == jq.pick_group_size(k, mode), k
    assert tq.pick_group_size(1600, "int4") == 32
    assert tq.pick_group_size(6400, "int4") == 128


@pytest.mark.parametrize("mode,group", [("int8", None), ("int8", 64), ("int4", None)])
def test_quantize_linear_bit_equal(rng, mode, group):
    """Stacked (L, K, N) weights with a bias and one all-zero column."""
    w = _w(rng, 3, 320, 96)
    w[:, :, 7] = 0.0
    b = rng.standard_normal((3, 96)).astype(np.float32)
    want = _both(jq.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, mode, group))
    got = _both(tq.quantize_linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                                   mode, group))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if mode == "int8" and group is None:
        assert got["scale"].shape == (3, 1, 96)  # per-channel


def test_unpack_int4_exact():
    """Every byte value, in both nibbles."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    want = np.asarray(jq.unpack_int4(jnp.asarray(packed)))
    got = tkernels.unpack_int4(torch.from_numpy(packed)).numpy()
    assert got.dtype == np.int8 and got.shape == (32, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_dequantize_linear_exact(rng, mode):
    w = _w(rng, 2, 256, 64)
    qp = jq.quantize_linear({"w": jnp.asarray(w)}, mode)
    want = np.asarray(jq.dequantize_linear(qp)["w"])
    tp = params_from_numpy(jax.tree.map(np.asarray, qp))
    np.testing.assert_array_equal(tq.dequantize_linear(tp)["w"].numpy(), want)


def _qmm_case(rng, mode, k, n, group=None):
    w = _w(rng, k, n)
    qp = jq.quantize_linear({"w": jnp.asarray(w)}, mode, group)
    packed = qp.get("qw", qp.get("qw4"))
    return qp, packed


@pytest.mark.parametrize("rows", [1, 5, 256])
@pytest.mark.parametrize("mode,k,n,group", [
    ("int8", 256, 150, None),  # per-channel, ragged N
    ("int8", 320, 96, 64),     # grouped INT8, K not a power of two
    ("int4", 256, 150, None),
    ("int4", 320, 96, None),   # G = 32, K/2 = 160
])
def test_qmm_plain_matches_pallas_kernel(rng, rows, mode, k, n, group):
    qp, packed = _qmm_case(rng, mode, k, n, group)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    want = jkernels.qmm(jnp.asarray(x), packed, qp["scale"], int4=(mode == "int4"),
                        interpret=True)
    got = tkernels.qmm(torch.from_numpy(x), _t(packed),
                       _t(qp["scale"]), int4=(mode == "int4"))
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qmm_plain_bf16_matches_pallas_kernel(rng, mode):
    """bf16 activations: per-channel sums x * q exactly in f32; grouped
    rounds each dequantized weight to bf16 first. K = 256 takes the TPU
    kernel's chunked path, where per-channel scales apply after the dot."""
    qp, packed = _qmm_case(rng, mode, 256, 128)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    want = jkernels.qmm(jnp.asarray(x).astype(jnp.bfloat16), packed, qp["scale"],
                        int4=(mode == "int4"), interpret=True)
    got = tkernels.qmm(torch.from_numpy(x).to(torch.bfloat16),
                       _t(packed),
                       _t(qp["scale"]), int4=(mode == "int4"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_grouped_matmul_matches_jax(rng, mode):
    qp, _ = _qmm_case(rng, mode, 256, 64, 32)
    q = jq.unpack_int4(qp["qw4"]) if mode == "int4" else qp["qw"]
    x = rng.standard_normal((3, 256)).astype(np.float32)
    want = jq._grouped_matmul_jnp(jnp.asarray(x), q, qp["scale"])
    got = tq.grouped_matmul(torch.from_numpy(x), _t(q),
                            _t(qp["scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The port's GEMV (scale folded into each weight) agrees with it.
    packed = _t(qp.get("qw", qp.get("qw4")))
    gemv = tkernels.qmm(torch.from_numpy(x), packed,
                        _t(qp["scale"]), int4=(mode == "int4"))
    np.testing.assert_allclose(gemv.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("lead", [(2, 3), (300,)], ids=["gemv", "dequant-matmul"])
def test_quantized_linear_matches_jax(rng, mode, lead):
    """Both branches: up to 256 rows the GEMV, above it dequantize then
    matmul; the bias is added after the cast to x's dtype."""
    w = _w(rng, 128, 64)
    b = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal((*lead, 128)).astype(np.float32)
    jp = jq.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, mode)
    want = jq.quantized_linear(jp, jnp.asarray(x))
    tp = tq.quantize_linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, mode)
    before = tkernels.qmm.launches
    got = tq.quantized_linear(tp, torch.from_numpy(x))
    assert got.shape == (*lead, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tkernels.qmm.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_matches_jax(mode):
    jp = jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(2))
    want = jax.tree.map(np.asarray, jq.quantize_params(jp, mode=mode))
    got = tq.quantize_params(params_from_numpy(jax.tree.map(np.asarray, jp)), mode=mode)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(want_leaves) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in want_leaves:
        node = got
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.from_numpy(leaf).dtype, path
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    head = got["lm_head"]
    assert set(head) == {"qw", "scale"}  # INT8 per-channel, also in INT4 mode
    assert head["qw"].shape == (128, 512) and head["scale"].shape == (1, 512)
    fc = got["blocks"]["mlp"]["c_fc"]
    assert ("qw4" if mode == "int4" else "qw") in fc and "b" in fc
    assert torch.equal(got["wte"], params_from_numpy(np.asarray(jp["wte"])))


def test_params_from_numpy_keeps_integer_leaves():
    """A dtype casts the float weights only: qw/qw4 stay int8 and equal,
    and the scales stay f32, as the JAX package keeps them."""
    jp = jq.quantize_params(jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(3)), "int4")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    qw4 = tp["blocks"]["attn"]["wq"]["qw4"]
    assert qw4.dtype == torch.int8
    np.testing.assert_array_equal(qw4.numpy(), np.asarray(jp["blocks"]["attn"]["wq"]["qw4"]))
    assert tp["lm_head"]["qw"].dtype == torch.int8
    np.testing.assert_array_equal(tp["lm_head"]["qw"].numpy(), np.asarray(jp["lm_head"]["qw"]))
    assert tp["wte"].dtype == torch.bfloat16
    assert tp["blocks"]["attn"]["wq"]["scale"].dtype == torch.float32
    assert tp["blocks"]["attn"]["wq"]["b"].dtype == torch.bfloat16
    assert tp["blocks"]["ln_1"]["w"].dtype == torch.bfloat16


def test_qmm_wrapper_rejects_unsupported_device():
    x = torch.zeros(1, 64, device="meta")
    with pytest.raises(ValueError):
        tkernels.qmm(x, torch.zeros(64, 8, dtype=torch.int8, device="meta"),
                     torch.zeros(1, 8, device="meta"))
