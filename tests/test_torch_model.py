"""The PyTorch port's GPT-2 model against the JAX package on the same
weights (CPU, nano/micro configs, f32), float and INT8/INT4 weights with a
float or INT8 KV cache.

Tolerance: ``tests.tolerance.assert_logits_close`` (atol 1e-4, rtol 2e-3),
the repo's end-to-end logits gate: torch's and XLA's CPU matmuls reduce in
different orders, so bit equality is not expected. For the INT8 cache the
JAX model runs under ``ZG2_FUSED_ATTN=interpret``, so that it takes the
deferred Pallas kernel (all f32, which the port follows) and not the jnp
reference, which rounds q and p * v_scale to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close
from zig_gpt2_tpu.config import GPT2_MICRO, GPT2_NANO, GPTConfig
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jquant
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.quant import quantize as tquant
from zig_gpt2_tpu_torch.weights import params_from_numpy, params_to_numpy


def _both(cfg, seed=3):
    jp = jgpt2.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tcfg = tconfig.GPTConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "context_size", "n_layers", "n_heads", "n_embed",
        "layer_norm_eps", "padded_heads", "padded_vocab_size")})
    return jp, tp, tcfg


def test_config_copy_matches():
    for name, cfg in tconfig.CONFIGS.items():
        from zig_gpt2_tpu.config import get_config

        ref = get_config(name)
        for f in ("vocab_size", "context_size", "n_layers", "n_heads", "n_embed",
                  "layer_norm_eps", "head_dim", "n_params"):
            assert getattr(cfg, f) == getattr(ref, f), (name, f)


def test_weight_bridge_roundtrip():
    jp, tp, _ = _both(GPT2_NANO)
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tp["blocks"]["attn"]["wq"]["w"].shape == (2, 128, 128)


def test_weight_bridge_bf16():
    jp = jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(1), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["wte"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params_to_numpy(tp)["wte"], np.asarray(jp["wte"]).astype(np.float32))


@pytest.mark.parametrize("cfg", [GPT2_NANO, GPT2_MICRO], ids=["nano", "micro"])
def test_forward_matches_jax(cfg):
    jp, tp, tcfg = _both(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = jgpt2.forward(jp, jnp.asarray(toks), cfg)
    got = tgpt2.forward(tp, torch.from_numpy(toks), tcfg)
    assert_logits_close(got.numpy(), np.asarray(want))


def test_padded_vocab_masked():
    cfg = GPTConfig(vocab_size=300, context_size=32, n_layers=1, n_heads=2,
                    n_embed=64, padded_vocab_size=320)
    jp, tp, tcfg = _both(cfg)
    toks = np.arange(6, dtype=np.int32)[None]
    want = np.asarray(jgpt2.forward(jp, jnp.asarray(toks), cfg))
    got = tgpt2.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    assert got.shape == (1, 6, 320)
    assert (got[..., 300:] < -1e37).all()
    assert_logits_close(got[..., :300], want[..., :300])


def test_prefill_and_decode_match_jax():
    """Bucket-padded prefill of two prompts of different lengths, then four
    decode steps: logits match the JAX package step by step, and the valid
    cache rows match."""
    cfg = GPT2_NANO
    jp, tp, tcfg = _both(cfg)
    rng = np.random.default_rng(1)
    T, lengths = 16, np.array([5, 11], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    toks[0, 5:] = 0
    toks[1, 11:] = 0
    jc = jgpt2.init_kv_cache(cfg, 2, 64)
    tc = tgpt2.init_kv_cache(tcfg, 2, 64)
    jc, jl = jgpt2.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), cfg)
    tc, tl = tgpt2.prefill(tp, tc, torch.from_numpy(toks), torch.from_numpy(lengths), tcfg)
    assert_logits_close(tl.numpy(), np.asarray(jl))
    for step in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        jc, jl = jgpt2.decode_step(jp, jc, jnp.asarray(nxt), cfg)
        tc, tl = tgpt2.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg=f"step {step}")
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    for b, n in enumerate(np.asarray(jc["length"])):
        assert_logits_close(tc["k"][:, b, :, :n].numpy(), np.asarray(jc["k"])[:, b, :, :n])
        assert_logits_close(tc["v"][:, b, :, :n].numpy(), np.asarray(jc["v"])[:, b, :, :n])


@pytest.mark.parametrize("mode", ["int4", "int8"])
@pytest.mark.parametrize("cfg", [GPT2_NANO, GPT2_MICRO], ids=["nano", "micro"])
def test_quantized_prefill_and_decode_match_jax(monkeypatch, cfg, mode):
    """Weights quantized by each package from the same float tree, an INT8
    KV cache: bucket-padded prefill of two prompts, then three decode
    steps. Logits match step by step; the valid cache rows' scales match
    and their int8 values differ by at most one step (a value that lands
    on a rounding boundary in one package's f32 and not the other's)."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    jp, tp, tcfg = _both(cfg)
    jp, tp = jquant.quantize_params(jp, mode), tquant.quantize_params(tp, mode)
    rng = np.random.default_rng(4)
    T, lengths = 16, np.array([5, 11], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    jc = jgpt2.init_kv_cache(cfg, 2, 32, quant="int8")
    tc = tgpt2.init_kv_cache(tcfg, 2, 32, quant="int8")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tc.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    jc, jl = jgpt2.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), cfg)
    tc, tl = tgpt2.prefill(tp, tc, torch.from_numpy(toks), torch.from_numpy(lengths), tcfg)
    assert_logits_close(tl.numpy(), np.asarray(jl), msg="prefill")
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        jc, jl = jgpt2.decode_step(jp, jc, jnp.asarray(nxt), cfg)
        tc, tl = tgpt2.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg=f"step {step}")
    for b, n in enumerate(np.asarray(jc["length"])):
        for name in ("k", "v"):
            got, want = tc[name][:, b, :, :n].numpy(), np.asarray(jc[name])[:, b, :, :n]
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
            assert_logits_close(tc[name + "_scale"][:, b, :, :n].numpy(),
                                np.asarray(jc[name + "_scale"])[:, b, :, :n])


def test_prefill_decode_equals_forward():
    """Prefill of a prefix then one decode step per remaining token gives
    the full forward's logits at every position (the port alone)."""
    _, tp, tcfg = _both(GPT2_MICRO, seed=5)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, 10)).astype(np.int32))
    full = tgpt2.forward(tp, toks, tcfg)
    cache = tgpt2.init_kv_cache(tcfg, 1, 32)
    padded = torch.zeros((1, 8), dtype=torch.int32)
    padded[0, :4] = toks[0, :4]
    cache, logits = tgpt2.prefill(tp, cache, padded, torch.tensor([4], dtype=torch.int32), tcfg)
    assert_logits_close(logits.numpy(), full[:, 3].numpy())
    for t in range(4, 10):
        cache, logits = tgpt2.decode_step(tp, cache, toks[:, t], tcfg)
        assert_logits_close(logits.numpy(), full[:, t].numpy(), msg=f"pos {t}")
    assert int(cache["length"][0]) == 10


def test_decode_updates_cache_in_place():
    _, tp, tcfg = _both(GPT2_NANO)
    cache = tgpt2.init_kv_cache(tcfg, 1, 16)
    k_before = cache["k"]
    cache2, _ = tgpt2.decode_step(tp, cache, torch.tensor([3], dtype=torch.int32), tcfg)
    assert cache2 is cache and cache2["k"] is k_before
    assert k_before[:, 0, :, 0].abs().sum() > 0
    assert k_before[:, 0, :, 1:].abs().sum() == 0


def test_unported_cache_layouts_raise():
    """The packed layout exists at head_dim 64 only (here 32); INT4 KV not at all."""
    cfg = tconfig.GPTConfig(vocab_size=64, context_size=16, n_layers=1,
                            n_heads=2, n_embed=64, kv_packed=True)
    with pytest.raises(ValueError, match="head_dim 64"):
        tgpt2.init_kv_cache(cfg)
    with pytest.raises(ValueError, match="head_dim 64"):
        tgpt2.init_kv_cache(cfg, quant="int8")
    with pytest.raises(ValueError):
        tgpt2.init_kv_cache(tconfig.GPT2_NANO, quant="int4")


def test_init_params_seeded():
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = tgpt2.init_params(tconfig.GPT2_NANO, g1)
    b = tgpt2.init_params(tconfig.GPT2_NANO, g2)
    assert torch.equal(a["blocks"]["mlp"]["c_fc"]["w"], b["blocks"]["mlp"]["c_fc"]["w"])
    assert a["blocks"]["attn"]["c_proj"]["w"].std() < a["wte"].std()
    assert a["blocks"]["attn"]["wq"]["w"].shape == (2, 128, 128)
