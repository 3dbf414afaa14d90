"""The port's w8a8 serving (per-channel INT8 weights, per-row INT8
activations, ``act_quant``) on the CPU against the JAX package's: greedy
tokens of the engine and of the continuous batcher (ring and linear),
identical, on trees quantized by the JAX package and carried across by
``params_from_numpy``. INT8-cache and packed cases run the JAX model under
``ZG2_FUSED_ATTN=interpret`` (its all-f32 kernel, which the port follows,
and its packed layout at head_dim 64); GPT2_NANO's head_dim 32 keeps both
packages unpacked, three heads of 64 pack with a phantom head.
"""

import dataclasses

import jax
import numpy as np
import pytest

from zig_gpt2_tpu.config import GPT2_NANO, GPTConfig, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine
from zig_gpt2_tpu_torch.weights import params_from_numpy

GREEDY = SamplingConfig(temperature=0.0)
CFG_ODD = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=3, n_embed=192)
CFGS = {"nano": GPT2_NANO, "odd": CFG_ODD}


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


def _w8a8_params(cfg, scale=3.0):
    """A float tree (x ``scale``, so that greedy streams differ per prompt)
    quantized INT8 per-channel by the JAX package, and the port's copy
    through the bridge."""
    jp = jq.quantize_params(
        jax.tree.map(lambda a: a * scale, jgpt2.init_params(cfg, jax.random.PRNGKey(0))),
        "int8")
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("cfg,kv_quant,packed", [
    ("nano", None, False), ("nano", "int8", False), ("odd", "int8", True)],
    ids=["unpacked-float", "unpacked-int8", "packed-int8-odd"])
def test_w8a8_engine_greedy_tokens_identical_to_jax(monkeypatch, cfg, kv_quant, packed):
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    monkeypatch.setenv("ZG2_KV_PACKED", "1" if packed else "0")
    cfg = dataclasses.replace(CFGS[cfg], act_quant=True)
    jp, tp = _w8a8_params(cfg)
    kw = dict(max_seq=32, prompt_buckets=(8,), kv_quant=kv_quant)
    jeng = JEngine(cfg, jp, **kw)
    teng = InferenceEngine(_tcfg(cfg), tp, device="cpu", **kw)
    assert jeng.config.kv_packed == teng.config.kv_packed == packed
    assert teng.config.act_quant
    for prompt in ([1, 2, 3, 4], [100, 7]):
        want = jeng.generate(prompt, 12, JSampling(temperature=0.0))
        assert teng.generate(prompt, 12, GREEDY) == want


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "linear"])
@pytest.mark.parametrize("cfg,kv_quant,packed", [
    ("nano", None, False), ("odd", "int8", True)], ids=["unpacked-float", "packed-int8-odd"])
def test_w8a8_batcher_greedy_tokens_identical_to_jax(monkeypatch, rng, cfg, kv_quant, packed,
                                                     ring):
    """Six requests through two slots (ring or linear cache): each request's
    greedy tokens equal the JAX batcher's."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    monkeypatch.setenv("ZG2_KV_PACKED", "1" if packed else "0")
    monkeypatch.setenv("ZG2_RING", "1" if ring else "0")
    cfg = dataclasses.replace(CFGS[cfg], act_quant=True)
    jp, tp = _w8a8_params(cfg)
    kw = dict(batch_size=2, max_seq=32, prompt_buckets=(8,), kv_quant=kv_quant)
    jb = JBatcher(cfg, jp, sampling=JSampling(temperature=0.0), **kw)
    tb = ContinuousBatcher(_tcfg(cfg), tp, sampling=GREEDY, device="cpu", **kw)
    assert jb._ring == tb._ring == ring and tb.config.kv_packed == packed
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in (3, 8, 5, 2, 7, 4)]

    def serve(b):
        rids = [b.submit(p, 10) for p in prompts]
        by_rid = {r.rid: r.generated for r in b.run()}
        return [by_rid[r] for r in rids]

    assert serve(tb) == serve(jb)
