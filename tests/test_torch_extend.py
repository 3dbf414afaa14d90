"""The port's ``gpt2.extend`` (CPU) against the JAX package's.

``extend`` runs a (B, T) window from each lane's cache length and returns
logits at every window position: the speculative verify and draft
catch-up, and a prefix-cache hit's suffix. Neither package runs a kernel
for its attention (plain ops; the INT8 form rounds q and p * v_scale to
bf16 in both), so the port is held to the JAX function at 2e-4 (atol and
rtol, the tolerance of the JAX package's own extend test): logits at the
valid rows and the appended cache rows (INT8 rows exactly), for float and
INT8 caches, unpacked (GPT2_NANO, head_dim 32) and head-pair packed (two
and three heads of 64, the odd count with the phantom head), float, INT4
and w8a8 weights, with a window shorter than T in one lane. One exception,
checked where it is taken: the INT8 op rounds q to bf16, so where an
element of q lies within two f32 ulps of a bf16 rounding midpoint, one ulp
of matmul order between the packages rounds it the other way; such a
window row is held to the bf16 tolerance below and the same argmax.

Against the port's own sequential ``decode_step``: float caches at 2e-4;
INT8 caches at the JAX package's bf16-einsum-vs-f32-kernel tolerance
(``tests/test_extend_packed.py``: rtol 2e-2, atol 5e-3, on its unscaled
weights), since the port's decode attention follows the all-f32 kernel
and extend the bf16 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_gpt2_tpu.config import GPT2_NANO, GPTConfig
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.ops import layers as tops
from zig_gpt2_tpu_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
INT8_VS_DECODE = dict(rtol=2e-2, atol=5e-3)
CFG_EVEN = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=2, n_embed=128)
CFG_ODD = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=3, n_embed=192)
CFGS = {"nano": GPT2_NANO, "even": CFG_EVEN, "odd": CFG_ODD}
B, P, T, S = 2, 8, 4, 24
LENGTHS = np.array([6, 4], np.int32)
VALID = np.array([4, 2], np.int32)


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


def _setup(cfg_name, weights, packed, scale=3.0):
    """(JAX config, JAX params, port config, port params): GPT-2 weights x
    ``scale`` from one seed, quantized by the JAX package (INT4, or INT8 per channel
    with ``act_quant`` for w8a8) and carried across by the bridge; the
    packed port tree gets its phantom head."""
    cfg = dataclasses.replace(CFGS[cfg_name], kv_packed=packed,
                              act_quant=weights == "w8a8")
    jp = jax.tree.map(lambda a: a * scale, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    if weights != "float":
        jp = jq.quantize_params(jp, "int4" if weights == "int4" else "int8")
    tp, tcfg = params_from_numpy(jax.tree.map(np.asarray, jp)), _tcfg(cfg)
    if packed:
        tp, tcfg = tgpt2.pad_phantom_head(tp, tcfg)
    return cfg, jp, tcfg, tp


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    window = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return prompt, window


def _port_prefilled(tp, tcfg, prompt, kv_quant, rows=S, lengths=LENGTHS):
    cache = tgpt2.init_kv_cache(tcfg, B, rows, quant=kv_quant)
    cache, _ = tgpt2.prefill(tp, cache, torch.from_numpy(prompt), torch.from_numpy(lengths),
                             tcfg)
    return cache


def _near_bf16_midpoint(x: torch.Tensor, ulps: int = 2) -> torch.Tensor:
    """True where an f32 element lies within ``ulps`` f32 ulps of the
    midpoint between two bf16 values (where rounding to bf16 can go either
    way for a one-ulp difference upstream)."""
    low = x.float().contiguous().view(torch.int32) & 0xFFFF
    return (low - 0x8000).abs() <= ulps


def _check_window(got, want, q_rows, msg):
    """(B, T, V) logits at the valid rows within TOL; a row whose recorded
    q (any layer) has an element at a bf16 midpoint is held to the bf16
    tolerance and the same argmax instead."""
    for b in range(B):
        for t in range(VALID[b]):
            if q_rows is not None and any(_near_bf16_midpoint(q[b, :, t]).any() for q in q_rows):
                np.testing.assert_allclose(got[b, t], want[b, t], **INT8_VS_DECODE,
                                           err_msg=f"{msg} lane {b} row {t} (bf16 midpoint)")
                assert got[b, t].argmax() == want[b, t].argmax()
                continue
            np.testing.assert_allclose(got[b, t], want[b, t], **TOL,
                                       err_msg=f"{msg} lane {b} row {t}")


def _recording_q(monkeypatch):
    """Record the q that each INT8 extend attention call rounds to bf16."""
    rows, plain = [], tops.extend_attention_quant

    def recording(q, *args):
        rows.append(q.detach().clone())
        return plain(q, *args)

    monkeypatch.setattr(tops, "extend_attention_quant", recording)
    return rows


def _rows_equal(got, want, name, rows_of):
    for b in range(B):
        g, w = got[name][:, b][:, :, rows_of(b)], want[name][:, b][:, :, rows_of(b)]
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} lane {b}")
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"{name} lane {b}")


CASES = [("nano", False, None, "float"), ("nano", False, None, "int4"),
         ("nano", False, None, "w8a8"), ("nano", False, "int8", "float"),
         ("nano", False, "int8", "int4"), ("nano", False, "int8", "w8a8"),
         ("even", True, None, "float"), ("even", True, "int8", "float"),
         ("even", True, "int8", "int4"), ("odd", True, None, "float"),
         ("odd", True, "int8", "float"), ("odd", True, "int8", "w8a8")]


@pytest.mark.parametrize("cfg_name,packed,kv_quant,weights", CASES,
                         ids=[f"{c}-{'packed' if p else 'unpacked'}-{k or 'float'}kv-{w}"
                              for c, p, k, w in CASES])
def test_extend_matches_jax(monkeypatch, cfg_name, packed, kv_quant, weights):
    """Prefill of two prompts (6 and 4 tokens), then a T=4 window with 4
    and 2 valid rows: logits at the valid rows, the appended rows and the
    new lengths equal the JAX package's."""
    q_rows = _recording_q(monkeypatch) if kv_quant else None
    cfg, jp, tcfg, tp = _setup(cfg_name, weights, packed)
    prompt, window = _inputs(cfg)
    jc = jgpt2.init_kv_cache(cfg, B, S, quant=kv_quant)
    jc, _ = jgpt2.prefill(jp, jc, jnp.asarray(prompt), jnp.asarray(LENGTHS), cfg)
    jc, jl = jgpt2.extend(jp, jc, jnp.asarray(window), jnp.asarray(VALID), cfg)
    tc = _port_prefilled(tp, tcfg, prompt, kv_quant)
    tc, tl = tgpt2.extend(tp, tc, torch.from_numpy(window), torch.from_numpy(VALID), tcfg)
    want, got = np.asarray(jl, np.float32), tl.numpy()
    assert got.shape == (B, T, tcfg.vocab_rows)
    _check_window(got, want, q_rows, "logits")
    gc, wc = params_to_numpy(tc), jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(gc["length"], LENGTHS + VALID)
    np.testing.assert_array_equal(gc["length"], wc["length"])
    for name in ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v"):
        assert gc[name].shape == wc[name].shape
        _rows_equal(gc, wc, name, lambda b: np.arange(LENGTHS[b], LENGTHS[b] + VALID[b]))


@pytest.mark.parametrize("cfg_name,packed,kv_quant", [
    ("nano", False, None), ("odd", True, "int8")], ids=["unpacked-float", "packed-int8-odd"])
def test_extend_past_headroom_clamps_like_jax(monkeypatch, cfg_name, packed, kv_quant):
    """A lane whose length is past S - T: its window starts at S - T, as
    the JAX package's dynamic_update_slice clamps it, writing back over the
    lane's own last rows; the other lane is untouched by the clamp. Logits
    and every row of both lanes equal the JAX package's."""
    q_rows = _recording_q(monkeypatch) if kv_quant else None
    cfg, jp, tcfg, tp = _setup(cfg_name, "float", packed)
    prompt, window = _inputs(cfg, seed=2)
    rows, lengths = 10, np.array([8, 3], np.int32)
    jc = jgpt2.init_kv_cache(cfg, B, rows, quant=kv_quant)
    jc, _ = jgpt2.prefill(jp, jc, jnp.asarray(prompt), jnp.asarray(lengths), cfg)
    jc, jl = jgpt2.extend(jp, jc, jnp.asarray(window), jnp.asarray(VALID), cfg)
    tc = _port_prefilled(tp, tcfg, prompt, kv_quant, rows, lengths)
    tc, tl = tgpt2.extend(tp, tc, torch.from_numpy(window), torch.from_numpy(VALID), tcfg)
    _check_window(tl.numpy(), np.asarray(jl), q_rows, "logits")
    gc, wc = params_to_numpy(tc), jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(gc["length"], wc["length"])
    assert gc["length"][0] > rows - 1  # lane 0 ran past the cache
    for name in ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v"):
        _rows_equal(gc, wc, name, lambda b: np.arange(min(rows, lengths[b] + VALID[b])))


def _sequential(tp, tcfg, cache, window):
    """T decode steps over a copy of ``cache``: (B, T, vocab) logits and
    the cache after them."""
    cache = {k: v.clone() for k, v in cache.items()}
    out = []
    for t in range(T):
        cache, logits = tgpt2.decode_step(tp, cache, torch.from_numpy(window[:, t]), tcfg)
        out.append(logits)
    return torch.stack(out, 1), cache


@pytest.mark.parametrize("wmm", ["0", "1"], ids=["matmul", "wmm"])
@pytest.mark.parametrize("cfg_name,packed", [("nano", False), ("odd", True)],
                         ids=["unpacked", "packed-odd"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_extend_matches_sequential_decode(monkeypatch, kv_quant, cfg_name, packed, wmm):
    """The port's extend against T of its own decode steps: logits at the
    valid rows, lengths advanced by ``valid``, the float cache's appended
    rows; the float linears through ``wmm``'s plain version under
    ``ZG2_WMM=1``. The weights are unscaled, as in the JAX package's own
    test of this comparison (x3 weights move the bf16 rounding of the INT8
    extend by up to 0.09 against the all-f32 decode)."""
    monkeypatch.setenv("ZG2_WMM", wmm)
    cfg, _, tcfg, tp = _setup(cfg_name, "float", packed, scale=1.0)
    prompt, window = _inputs(cfg, seed=3)
    cache = _port_prefilled(tp, tcfg, prompt, kv_quant)
    want, seq = _sequential(tp, tcfg, cache, window)
    tc, got = tgpt2.extend(tp, cache, torch.from_numpy(window), torch.from_numpy(VALID), tcfg)
    tol = INT8_VS_DECODE if kv_quant else TOL
    for b in range(B):
        np.testing.assert_allclose(got[b, :VALID[b]].numpy(), want[b, :VALID[b]].numpy(), **tol,
                                   err_msg=f"lane {b}")
    np.testing.assert_array_equal(tc["length"].numpy(), LENGTHS + VALID)
    if not kv_quant:
        _rows_equal(params_to_numpy(tc), params_to_numpy(seq), "k",
                    lambda b: np.arange(LENGTHS[b], LENGTHS[b] + VALID[b]))


def test_extend_routes_linears_like_decode(monkeypatch):
    """At B * T rows within the cap a quantized linear takes ``qmm``: 6 per
    layer and the lm_head, as the 1.5B verify window's 289 launches on the
    card count them; a ring cache is refused."""
    from zig_gpt2_tpu_torch.quant import kernels

    calls = []
    plain = kernels.qmm

    def counting(x, *a, **kw):
        calls.append(x.shape[0])
        return plain(x, *a, **kw)

    monkeypatch.setattr(kernels, "qmm", counting)
    cfg, _, tcfg, tp = _setup("nano", "int4", False)
    prompt, window = _inputs(cfg)
    cache = _port_prefilled(tp, tcfg, prompt, None)
    calls.clear()
    tgpt2.extend(tp, cache, torch.from_numpy(window), torch.from_numpy(VALID), tcfg)
    assert calls == [B * T] * (6 * cfg.n_layers + 1)
    ring = dataclasses.replace(tcfg, ring_cache=True)
    with pytest.raises(ValueError, match="ring"):
        tgpt2.extend(tp, tgpt2.init_kv_cache(ring, B, S), torch.from_numpy(window),
                     torch.from_numpy(VALID), ring)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_extend_attention_ops_match_jax(rng, quant):
    """The two attention ops alone, bf16 q, against the JAX ops."""
    from zig_gpt2_tpu.ops import layers as jops

    q = rng.standard_normal((2, 3, T, 32)).astype(np.float32)
    base, valid = np.array([5, 0], np.int32), np.array([4, 1], np.int32)
    if quant:
        caches = [rng.integers(-127, 128, (2, 3, 12, 32)).astype(np.int8),
                  (rng.random((2, 3, 12)) * 0.05 + 1e-3).astype(np.float32)] * 2
        jfn, tfn = jops.extend_attention_quant, tops.extend_attention_quant
    else:
        caches = [rng.standard_normal((2, 3, 12, 32)).astype(np.float32) for _ in range(2)]
        jfn, tfn = jops.extend_attention, tops.extend_attention
    want = jfn(jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, caches), jnp.asarray(base),
               jnp.asarray(valid))
    got = tfn(torch.from_numpy(q).to(torch.bfloat16), *map(torch.from_numpy, caches),
              torch.from_numpy(base), torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1.6e-2, atol=1e-2)
    np.testing.assert_array_equal(
        tops._extend_mask(torch.from_numpy(base), torch.from_numpy(valid), T, 12).numpy(),
        np.asarray(jops._extend_mask(jnp.asarray(base), jnp.asarray(valid), T, 12)))
