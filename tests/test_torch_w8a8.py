"""The port's w8a8 path (``--quant w8a8``: per-channel INT8 weights, per-row
INT8 activations) on the CPU against the JAX package.

Comparisons that are exact, and why:
- ``quantize_rows``: both packages take the f32 absmax, divide by 127,
  divide x by the scale and round half to even, element for element.
- ``w8a8_matmul``, ``qmm_plain(w8a8=True)`` and the JAX package's
  ``w8a8_matmul``: the int8 products are summed exactly (int32 in JAX, f64
  in the port, |sum| < 2^53), the whole number is rounded once to f32, and
  the f32 tail ``acc * sx * scale`` is taken in one order.
- The JAX package's Pallas w8a8 body in interpret mode is not bit-equal to
  its own ``w8a8_matmul`` (its own test allows 1e-5): compiled, its row
  scale is absmax * (1/127), one ulp off absmax / 127 for some rows. The
  port's arithmetic with that scale equals it bit for bit.
- ``quantized_linear(act_quant=True)``: the same product plus the same bias
  in x's dtype.

Model logits are held to ``assert_logits_close`` (the float ops around the
linears reduce in another order; ``tests/test_torch_w8a8_serving.py``
holds the engine's and the batcher's greedy tokens). INT8-cache and packed
cases run the JAX model under ``ZG2_FUSED_ATTN=interpret`` (its all-f32
kernel, which the port follows, and its packed layout at head_dim 64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close
from zig_gpt2_tpu.config import GPT2_NANO, GPTConfig
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import kernels as jkernels
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu_torch import cli as tcli
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.quant import kernels as tkernels
from zig_gpt2_tpu_torch.quant import quantize as tq
from zig_gpt2_tpu_torch.weights import params_from_numpy

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
CFG_ODD = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=3, n_embed=192)
CFGS = {"nano": GPT2_NANO, "odd": CFG_ODD}


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


def _rows(rng, k):
    """Activation rows with the rounding's edge cases: exact .5 steps (absmax
    127 or 254: scale 1 or 2), an all-zero row (the 1e-12 floor), a row whose
    absmax is a negative entry, a tiny row, and random rows."""
    halves = np.zeros(k, np.float32)
    halves[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -126.5]
    doubled = np.zeros(k, np.float32)
    doubled[:6] = [254.0, 1.0, 3.0, -5.0, 7.0, -253.0]
    neg = rng.standard_normal(k).astype(np.float32)
    neg[3] = -8.0
    tiny = (rng.standard_normal(k) * 1e-30).astype(np.float32)
    rand = rng.standard_normal((3, k)).astype(np.float32) * 2.0
    return np.stack([halves, doubled, np.zeros(k, np.float32), neg, tiny, *rand])


def _per_channel(rng, k, n, lead=()):
    w = (rng.standard_normal((*lead, k, n)) * 0.05).astype(np.float32)
    jp = jq.quantize_linear({"w": jnp.asarray(w)}, "int8")
    return jp, {"qw": torch.from_numpy(np.array(jp["qw"])),
                "scale": torch.from_numpy(np.array(jp["scale"]))}


# --- the arithmetic -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_bit_equal(rng, dtype):
    x = _rows(rng, 320)
    jx = jnp.asarray(x).astype(JDT[dtype])
    want_q, want_s = (np.asarray(a) for a in jq.quantize_rows(jx))
    got_q, got_s = tq.quantize_rows(torch.from_numpy(x).to(TDT[dtype]))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # The edge cases are what they were built to be.
    assert got_s[0] == 1.0 and got_s[1] == 2.0
    assert got_q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 64, -126]  # half to even
    assert got_q[1, :6].tolist() == [127, 0, 2, -2, 4, -126]
    assert not got_q[2].any() and got_s[2] == np.float32(np.float32(1e-12) / np.float32(127))
    assert got_q[3, 3] == -127


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", [(256, 150), (320, 96)], ids=["ragged-n", "k320"])
@pytest.mark.parametrize("rows", [1, 2, 8, 16, 17, 33, 64])
def test_w8a8_products_bit_equal(rng, rows, k, n, dtype):
    """The port's plain w8a8 product (``w8a8_matmul`` and
    ``qmm_plain(w8a8=True)``, which is what ``qmm`` runs on a CPU tensor)
    equals the JAX package's ``w8a8_matmul`` and its Pallas kernel's w8a8
    body in interpret mode, bit for bit."""
    jp, tp = _per_channel(rng, k, n)
    x = np.concatenate([_rows(rng, k), rng.standard_normal((64, k)).astype(np.float32)])
    x = x[:rows]
    jx, tx = jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    want = np.asarray(jq.w8a8_matmul(jx, jp["qw"], jp["scale"]))
    before = tkernels.qmm.w8a8_launches
    for got in (tq.w8a8_matmul(tx, tp["qw"], tp["scale"]),
                tkernels.qmm_plain(tx, tp["qw"], tp["scale"], w8a8=True),
                tkernels.qmm(tx, tp["qw"], tp["scale"], w8a8=True)):
        assert got.dtype == torch.float32 and got.shape == (rows, n)
        np.testing.assert_array_equal(got.numpy(), want)
    assert tkernels.qmm.w8a8_launches == before  # the CPU runs the plain version
    # The JAX kernel in interpret mode: its compiled body takes the row scale
    # as absmax * (1/127), not absmax / 127, which differs in the last bit
    # for some rows. With that one scale the port's arithmetic gives its
    # output bit for bit.
    interp = np.asarray(jkernels.qmm(jx, jp["qw"], jp["scale"], w8a8=True, interpret=True))
    xf = tx.float()
    sx = xf.abs().amax(-1).clamp(min=1e-12) * torch.tensor(1 / 127, dtype=torch.float32)
    xq = torch.round(xf / sx[:, None]).clamp(-127, 127)
    np.testing.assert_array_equal(
        tkernels.w8a8_tail(xq.double() @ tp["qw"].double(), sx, tp["scale"]).numpy(), interp)


def test_w8a8_sums_are_exact_past_f32():
    """Saturated rows at K = 6400: every product +-127 * 127, sums near
    1.03e8, past f32's 2^24 whole numbers. The port's f64 sums are exact, as
    JAX's int32 sums are: the result is the exact sum rounded once."""
    k, n = 6400, 16
    x = np.full((2, k), 3.0, np.float32)
    x[1, ::2] = -3.0
    qw = np.full((k, n), 127, np.int8)
    qw[:, 1::2] = -127
    qw[5, 2] = 126
    scale = np.full((1, n), 0.01, np.float32)
    want = np.asarray(jq.w8a8_matmul(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(scale)))
    got = tq.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = 127 * 127 * (k - 1) + 127 * 126  # row 0, column 2
    sx = np.float32(3.0) / np.float32(127.0)
    assert want[0, 2] == np.float32(exact) * sx * np.float32(0.01)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 64, 65])
def test_quantized_linear_act_quant_per_channel(rng, monkeypatch, rows, dtype):
    """Per-channel INT8 under act_quant: up to 64 rows the s8 x s8 body of
    qmm, 65 rows ``w8a8_matmul``; equal to the JAX package's
    ``quantized_linear(act_quant=True)`` with the bias, bit for bit."""
    jp, tp = _per_channel(rng, 256, 96)
    b = rng.standard_normal(96).astype(np.float32)
    jp["b"], tp["b"] = jnp.asarray(b).astype(JDT[dtype]), torch.from_numpy(b).to(TDT[dtype])
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    want = jq.quantized_linear(jp, jnp.asarray(x).astype(JDT[dtype]), act_quant=True)
    calls = []
    qmm, w8a8_matmul = tkernels.qmm, tq.w8a8_matmul
    monkeypatch.setattr(tkernels, "qmm",
                        lambda *a, **kw: calls.append(("qmm", kw)) or qmm(*a, **kw))
    monkeypatch.setattr(tq, "w8a8_matmul",
                        lambda *a: calls.append(("w8a8_matmul", {})) or w8a8_matmul(*a))
    got = tq.quantized_linear(tp, torch.from_numpy(x).to(TDT[dtype]), act_quant=True)
    assert got.dtype == TDT[dtype]
    np.testing.assert_array_equal(_np(got), _np(want))
    assert calls == ([("qmm", {"w8a8": True})] if rows <= 64 else [("w8a8_matmul", {})])


@pytest.mark.parametrize("mode,group", [("int8", 64), ("int4", None)], ids=["int8-g64", "int4"])
@pytest.mark.parametrize("rows", [2, 65])
def test_quantized_linear_act_quant_leaves_grouped_weight_only(rng, mode, group, rows):
    """A grouped INT8 or an INT4 linear ignores act_quant (JAX
    ``tests/test_quant.py``, ``test_quantized_linear_act_quant_dispatch``):
    the same weight-only result, and the JAX package's within its 2e-5."""
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    jp = jq.quantize_linear({"w": jnp.asarray(w), "b": None}, mode, group)
    tp = params_from_numpy(jax.tree.map(np.asarray, {k: v for k, v in jp.items() if k != "b"}))
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    tx = torch.from_numpy(x)
    got = tq.quantized_linear(tp, tx, act_quant=True)
    np.testing.assert_array_equal(got.numpy(), tq.quantized_linear(tp, tx).numpy())
    want = jq.quantized_linear(jp, jnp.asarray(x), act_quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_bridged_int8_tree_gives_jax_act_quant_outputs(rng):
    """A tree quantized by the JAX package (``quantize_params(mode="int8")``)
    crosses ``params_from_numpy`` unchanged for w8a8 serving: every block
    linear at every layer and the lm_head give the JAX package's
    ``quantized_linear(act_quant=True)`` outputs bit for bit, at 1 and 5
    rows, f32 and bf16 activations."""
    jparams = jq.quantize_params(jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(4)), "int8")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    cases = [(jparams["lm_head"], tparams["lm_head"])]
    for mod, name in tq._BLOCK_LINEARS:
        jl, tl = jparams["blocks"][mod][name], tparams["blocks"][mod][name]
        cases += [({k: v[i] for k, v in jl.items()}, tgpt2._layer(tl, i))
                  for i in range(GPT2_NANO.n_layers)]
    for jl, tl in cases:
        assert tl["scale"].shape[0] == 1  # per-channel: w8a8 applies
        k = tl["qw"].shape[0]
        for rows in (1, 5):
            x = rng.standard_normal((rows, k)).astype(np.float32)
            for dtype in ("f32", "bf16"):
                want = jq.quantized_linear(jl, jnp.asarray(x).astype(JDT[dtype]),
                                           act_quant=True)
                got = tq.quantized_linear(tl, torch.from_numpy(x).to(TDT[dtype]),
                                          act_quant=True)
                np.testing.assert_array_equal(_np(got), _np(want))


# --- the model and the runtimes ---------------------------------------------------

def _w8a8_params(cfg, scale=3.0):
    """A float tree (x ``scale``, so that greedy streams differ per prompt)
    quantized INT8 per-channel by the JAX package, and the port's copy
    through the bridge."""
    jp = jq.quantize_params(
        jax.tree.map(lambda a: a * scale, jgpt2.init_params(cfg, jax.random.PRNGKey(0))),
        "int8")
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("cfg,kv_quant,packed", [
    ("nano", None, False), ("nano", "int8", False), ("odd", None, True),
    ("odd", "int8", True)],
    ids=["unpacked-float", "unpacked-int8", "packed-float-odd", "packed-int8-odd"])
def test_w8a8_model_matches_jax(monkeypatch, rng, cfg, kv_quant, packed):
    """Prefill of two prompts (5 and 8 tokens) and six decode steps with
    act_quant: logits within ``assert_logits_close`` at every step (the
    JAX model's CPU path is ``w8a8_matmul``, which the port's plain w8a8
    GEMV equals bit for bit)."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    cfg = dataclasses.replace(CFGS[cfg], act_quant=True, kv_packed=packed)
    jp, tp = _w8a8_params(cfg)
    tcfg = _tcfg(cfg)
    if packed:
        tp, tcfg = tgpt2.pad_phantom_head(tp, tcfg)
    jc = jgpt2.init_kv_cache(cfg, 2, 16, quant=kv_quant)
    tc = tgpt2.init_kv_cache(tcfg, 2, 16, quant=kv_quant)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = np.array([5, 8], np.int32)
    jc, jl = jgpt2.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), cfg)
    tc, tl = tgpt2.prefill(tp, tc, torch.from_numpy(toks), torch.from_numpy(lengths), tcfg)
    assert_logits_close(tl.numpy(), np.asarray(jl), msg="prefill")
    for step in range(6):
        nxt = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        jc, jl = jgpt2.decode_step(jp, jc, jnp.asarray(nxt), cfg)
        tc, tl = tgpt2.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg=f"step {step}")


@pytest.mark.parametrize("flags", [[], ["--kv-quant"]], ids=["float-kv", "int8-kv"])
def test_cli_demo_w8a8_cpu(capsys, monkeypatch, flags):
    """--quant w8a8 serves --demo on the CPU: INT8 weights with act_quant,
    every linear through the w8a8 path."""
    calls = []
    w8a8 = tq.quantized_linear
    monkeypatch.setattr(tgpt2, "quantized_linear",
                        lambda p, x, act_quant=False: calls.append(act_quant)
                        or w8a8(p, x, act_quant=act_quant))
    tcli.main(["--demo", "--device", "cpu", "--quant", "w8a8", *flags, "--max-tokens", "6",
               "--temp", "0", "--metrics", "the quick"])
    out, err = capsys.readouterr()
    assert out.startswith("the quick")
    assert '"generated_tokens": 6' in err
    assert calls and all(calls)
