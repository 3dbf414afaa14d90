"""The port's float decode GEMV (``wmm``, ``ZG2_WMM=1``) on the CPU against
the JAX package's (``ZG2_WMM=interpret``: its Pallas kernel in interpret
mode).

Tolerances: ``wmm_plain`` against the JAX kernel, ``assert_tensors_close``
(the same f32 products of x and the weight rounded to x's dtype, summed in
another order). Model logits, ``assert_logits_close``; greedy engine
tokens at f32, identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close, assert_tensors_close
from zig_gpt2_tpu.config import GPT2_NANO, GPTConfig, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import kernels as jkernels
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.quant import kernels as tkernels
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine
from zig_gpt2_tpu_torch.weights import params_from_numpy

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
CFG_EVEN = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=2, n_embed=128)


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


@pytest.mark.parametrize("wdtype", ["f32", "bf16"])
@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,n", [(1, 256), (4, 150), (65, 384)],
                         ids=["b1-n256", "b4-n150", "b65-n384"])
def test_wmm_plain_matches_pallas_kernel(rng, rows, n, xdtype, wdtype):
    """x and w in f32 or bf16 (an f32 weight under a bf16 x is rounded to
    bf16 first); N not a multiple of 128; rows past the w8a8 cap."""
    w = rng.standard_normal((128, n)).astype(np.float32)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(JDT[xdtype]), jnp.asarray(w).astype(JDT[wdtype])
    tx, tw = torch.from_numpy(x).to(TDT[xdtype]), torch.from_numpy(w).to(TDT[wdtype])
    want = np.asarray(jkernels.wmm(jx, jw, interpret=True))
    before = tkernels.wmm.launches
    for got in (tkernels.wmm(tx, tw), tkernels.wmm_plain(tx, tw)):
        assert got.dtype == torch.float32 and got.shape == (rows, n)
        assert_tensors_close(got.numpy(), want)
    assert tkernels.wmm.launches == before  # the CPU runs the plain version


def test_wmm_plain_stacked_layer_views(rng):
    """The layer loop passes the view w[idx] of the stacked (L, K, N)
    weight, as the JAX kernel's stacked mode selects the layer."""
    ws = rng.standard_normal((3, 64, 256)).astype(np.float32)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    tws = torch.from_numpy(ws)
    for layer in range(3):
        want = jkernels.wmm(jnp.asarray(x), jnp.asarray(ws), layer=jnp.int32(layer),
                            interpret=True)
        assert tws[layer].is_contiguous()
        assert_tensors_close(tkernels.wmm(torch.from_numpy(x), tws[layer]).numpy(),
                             np.asarray(want))


def _params(cfg, dtype=jnp.float32):
    jp = jax.tree.map(lambda a: a * 3.0, jgpt2.init_params(cfg, jax.random.PRNGKey(0), dtype))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("cfg,packed", [(GPT2_NANO, False), (CFG_EVEN, True)],
                         ids=["nano-unpacked", "even-packed"])
def test_wmm_model_decode_matches_jax(monkeypatch, rng, cfg, packed):
    """ZG2_WMM=1 in the port against ZG2_WMM=interpret in the JAX package:
    prefill of two prompts, then four decode steps; logits within
    ``assert_logits_close``. The decode steps send every float block linear
    through ``wmm`` (6 per layer), the prefill none."""
    monkeypatch.setenv("ZG2_WMM", "interpret")
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    cfg = dataclasses.replace(cfg, kv_packed=packed)
    jp, tp = _params(cfg)
    tcfg = _tcfg(cfg)
    jc = jgpt2.init_kv_cache(cfg, 2, 16)
    tc = tgpt2.init_kv_cache(tcfg, 2, 16)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = np.array([5, 8], np.int32)
    jc, jl = jgpt2.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), cfg)
    calls = []
    wmm = tkernels.wmm
    monkeypatch.setattr(tkernels, "wmm", lambda x, w: calls.append(x.shape) or wmm(x, w))
    monkeypatch.setenv("ZG2_WMM", "1")
    tc, tl = tgpt2.prefill(tp, tc, torch.from_numpy(toks), torch.from_numpy(lengths), tcfg)
    assert calls == []
    assert_logits_close(tl.numpy(), np.asarray(jl), msg="prefill")
    for step in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        monkeypatch.setenv("ZG2_WMM", "interpret")
        jc, jl = jgpt2.decode_step(jp, jc, jnp.asarray(nxt), cfg)
        monkeypatch.setenv("ZG2_WMM", "1")
        tc, tl = tgpt2.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg=f"step {step}")
    assert len(calls) == 4 * 6 * cfg.n_layers and set(calls) == {(2, cfg.n_embed),
                                                                  (2, 4 * cfg.n_embed)}


def test_wmm_engine_greedy_tokens_identical_to_jax(monkeypatch):
    """f32 weights: the port's engine under ZG2_WMM=1 gives the JAX engine's
    greedy tokens under ZG2_WMM=interpret, and its own without wmm."""
    jp, tp = _params(GPT2_NANO)
    kw = dict(max_seq=32, prompt_buckets=(8,))
    monkeypatch.setenv("ZG2_WMM", "interpret")
    jeng = JEngine(GPT2_NANO, jp, **kw)
    monkeypatch.setenv("ZG2_WMM", "1")
    teng = InferenceEngine(_tcfg(GPT2_NANO), tp, device="cpu", **kw)
    for prompt in ([1, 2, 3, 4], [100, 7]):
        monkeypatch.setenv("ZG2_WMM", "interpret")
        want = jeng.generate(prompt, 12, JSampling(temperature=0.0))
        monkeypatch.setenv("ZG2_WMM", "1")
        got = teng.generate(prompt, 12, SamplingConfig(temperature=0.0))
        assert got == want
        monkeypatch.setenv("ZG2_WMM", "0")
        assert teng.generate(prompt, 12, SamplingConfig(temperature=0.0)) == want


def test_wmm_switch(monkeypatch):
    """ZG2_WMM takes 0 (the default) or 1; anything else raises, as
    ZG2_KV_PACKED does. Under act_quant the float cap is the w8a8 one."""
    monkeypatch.delenv("ZG2_WMM", raising=False)
    assert not tgpt2._use_wmm()
    monkeypatch.setenv("ZG2_WMM", "1")
    assert tgpt2._use_wmm()
    for bad in ("interpret", "yes", ""):
        monkeypatch.setenv("ZG2_WMM", bad)
        with pytest.raises(ValueError, match="ZG2_WMM"):
            tgpt2._use_wmm()
    cfg = _tcfg(GPT2_NANO)
    assert tgpt2._qmm_cap(cfg, int4=False) == tkernels.GEMV_MAX_ROWS == 256
    aq = dataclasses.replace(cfg, act_quant=True)
    assert tgpt2._qmm_cap(aq, int4=False) == tkernels.W8A8_MAX_ROWS == 64
    assert tgpt2._qmm_cap(aq, int4=True) == 256


def test_wmm_wrapper_rejects_unsupported_device():
    with pytest.raises(ValueError):
        tkernels.wmm(torch.zeros(1, 64, device="meta"), torch.zeros(64, 8, device="meta"))
