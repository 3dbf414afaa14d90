"""The fused QKV projection, ``ZG2_QMM=0`` and the engine's ``cache_dtype``
in the port (CPU) against the JAX package.

``ZG2_FUSE_QKV=1``: ``models.gpt2.fuse_qkv_params`` concatenates Q, K and
V on N (float, INT8 or INT4 leaves and their scales), applied by
``prepare_serving`` after the packed layout's phantom head is padded in,
so each third of ``wqkv`` holds the padded heads. Each output column of
the fused product is the same contraction as in the split ones, so logits
agree within 1e-5 and greedy streams exactly, with the JAX package's
fused runtimes too. The JAX side runs its INT8 and packed attention as the
port's plain versions do (``ZG2_FUSED_ATTN=interpret``). Weights are
GPT2_NANO's times 3, so that greedy streams differ per prompt.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from zig_gpt2_tpu.config import GPT2_NANO, GPTConfig, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.quant import kernels as tkernels
from zig_gpt2_tpu_torch.quant import quantize as tq
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.ops import attention as tattention
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = tconfig.GPT2_NANO
GREEDY, JGREEDY = SamplingConfig(temperature=0.0), JSampling(temperature=0.0)
CFG_ODD = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=3, n_embed=192)
PROMPTS = ([1, 2, 3, 4, 5, 6, 7], [300, 12, 99])


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


def _params(cfg):
    jp = jax.tree.map(lambda x: x * 3.0, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def params():
    return _params(GPT2_NANO)


def _quantized(params, quant):
    jp, tp = params
    if quant is None:
        return jp, tp
    return jq.quantize_params(jp, mode=quant), tq.quantize_params(tp, mode=quant)


@pytest.mark.parametrize("quant", [None, "int8", "int4"], ids=["float", "int8", "int4"])
def test_fused_leaf_shapes_and_idempotence(params, quant):
    jp, tp = _quantized(params, quant)
    fused = tgpt2.fuse_qkv_params(tp)
    attn = fused["blocks"]["attn"]
    assert "wq" not in attn and "wqkv" in attn and "wq" in tp["blocks"]["attn"]
    want = jgpt2.fuse_qkv_params(jp)["blocks"]["attn"]["wqkv"]
    assert sorted(attn["wqkv"]) == sorted(want)
    for key, leaf in attn["wqkv"].items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[key]), err_msg=key)
    L, E, A = GPT2_NANO.n_layers, GPT2_NANO.n_embed, GPT2_NANO.n_embed
    rows = {None: E, "int8": E, "int4": E // 2}[quant]
    assert attn["wqkv"]["w" if quant is None else "qw4" if quant == "int4" else "qw"].shape \
        == (L, rows, 3 * A)
    assert attn["wqkv"]["b"].shape == (L, 3 * A)
    assert tgpt2.fuse_qkv_params(fused) is fused


@pytest.mark.parametrize("quant", [None, "int4"], ids=["float", "int4"])
def test_forward_matches_split_and_jax(params, rng, quant):
    """Fused against split within 1e-5, and against the JAX package's fused
    forward within ``assert_logits_close``."""
    jp, tp = _quantized(params, quant)
    toks = rng.integers(0, GPT2_NANO.vocab_size, (2, 9))
    want = tgpt2.forward(tp, torch.from_numpy(toks), TCFG).numpy()
    got = tgpt2.forward(tgpt2.fuse_qkv_params(tp), torch.from_numpy(toks), TCFG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jfused = jgpt2.forward(jgpt2.fuse_qkv_params(jp), jnp.asarray(toks), GPT2_NANO)
    assert_logits_close(got, np.asarray(jfused))


@pytest.mark.parametrize("quant,kv_quant", [(None, None), ("int4", None), ("int8", "int8")],
                         ids=["float", "int4", "int8-kv8"])
def test_engine_greedy_identity(params, monkeypatch, quant, kv_quant):
    """Prefill and decode with ZG2_FUSE_QKV=1: the unfused port's tokens,
    and for float and INT4 weights the fused JAX engine's (the unfused
    port's INT8-cache engine is held to the JAX package's in
    ``tests/test_torch_engine_tokenizer.py``)."""
    jp, tp = _quantized(params, quant)
    kw = dict(max_seq=48, prompt_buckets=(16,), kv_quant=kv_quant)
    out = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("ZG2_FUSE_QKV", fused)
        eng = InferenceEngine(TCFG, tp, device="cpu", **kw)
        assert ("wqkv" in eng.params["blocks"]["attn"]) == (fused == "1")
        out[fused] = [eng.generate(p, 10, GREEDY) for p in PROMPTS]
    assert out["1"] == out["0"]
    assert len(set(map(tuple, out["1"]))) == len(PROMPTS)
    if kv_quant is None:
        jeng = JEngine(GPT2_NANO, jp, **kw)
        assert "wqkv" in jeng.params["blocks"]["attn"]
        assert out["1"] == [jeng.generate(p, 10, JGREEDY) for p in PROMPTS]


@pytest.mark.parametrize("spec", [False, True], ids=["ring", "speculative"])
def test_batcher_with_fusion_identical_to_jax(params, monkeypatch, rng, spec):
    """The ring batcher, and the speculative (prompt lookup, extend) one,
    both fused as the JAX package's fuse them: the JAX fused batcher's
    tokens and the unfused port's."""
    monkeypatch.setenv("ZG2_FUSE_QKV", "1")
    jp, tp = params
    prompts = [[int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, n)] for n in (3, 9, 5)]
    prompts[1] = [5, 6, 7, 5, 6, 7, 5, 6, 7]  # something for the lookup to find
    kw = dict(batch_size=2, max_seq=40, prompt_buckets=(16,))
    if spec:
        kw.update(speculative="ngram", spec_k=3)

    def serve(b):
        rids = [b.submit(p, 8) for p in prompts]
        by_rid = {r.rid: r.generated for r in b.run()}
        return [by_rid[r] for r in rids]

    tb = ContinuousBatcher(TCFG, tp, sampling=GREEDY, device="cpu", **kw)
    assert "wqkv" in tb.params["blocks"]["attn"]
    got = serve(tb)
    jb = JBatcher(GPT2_NANO, jp, sampling=JGREEDY, **kw)
    assert "wqkv" in jb.params["blocks"]["attn"]
    assert got == serve(jb)
    monkeypatch.setenv("ZG2_FUSE_QKV", "0")
    assert got == serve(ContinuousBatcher(TCFG, tp, sampling=GREEDY, device="cpu", **kw))


def test_extend_with_fusion(params, rng):
    jp, tp = params
    toks = torch.from_numpy(rng.integers(0, GPT2_NANO.vocab_size, (2, 6)))
    out = []
    for p in (tp, tgpt2.fuse_qkv_params(tp)):
        cache = tgpt2.init_kv_cache(TCFG, 2, 32)
        cache, _ = tgpt2.prefill(p, cache, toks[:, :3], torch.tensor([3, 2]), TCFG)
        out.append(tgpt2.extend(p, cache, toks[:, 3:], torch.tensor([3, 2]), TCFG)[1].numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant,kv_quant", [(None, None), ("int4", "int8")],
                         ids=["float", "int4-kv8"])
def test_odd_heads_packed_fuses_after_the_phantom_head(monkeypatch, quant, kv_quant):
    """Three heads of 64 on the packed layout: the phantom head is padded
    into Q, K and V first, so wqkv is 3 x 4 x 64 wide and splits at equal
    thirds. Greedy tokens equal the unfused packed engine's and, with
    float weights and cache, the JAX package's fused packed engine's
    (which pads per step; the unfused INT8 packed engine is held to the JAX
    package's in ``tests/test_torch_packed.py``)."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    monkeypatch.setenv("ZG2_KV_PACKED", "1")
    jp, tp = _quantized(_params(CFG_ODD), quant)
    kw = dict(max_seq=32, prompt_buckets=(8,), kv_quant=kv_quant)
    out = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("ZG2_FUSE_QKV", fused)
        eng = InferenceEngine(_tcfg(CFG_ODD), tp, device="cpu", **kw)
        assert eng.config.kv_packed and eng.config.attn_heads == 4
        out[fused] = [eng.generate(p, 10, GREEDY) for p in ([1, 2, 3, 4], [100, 7])]
    wqkv = eng.params["blocks"]["attn"]["wqkv"]
    assert wqkv["b"].shape[-1] == 3 * 4 * 64
    assert out["1"] == out["0"]
    if quant is None:
        jeng = JEngine(CFG_ODD, jp, **kw)
        assert jeng.config.kv_packed and "wqkv" in jeng.params["blocks"]["attn"]
        assert out["1"] == [jeng.generate(p, 10, JGREEDY) for p in ([1, 2, 3, 4], [100, 7])]
    with pytest.raises(ValueError, match="before fusing"):
        tgpt2.pad_phantom_head(tgpt2.fuse_qkv_params(tp), _tcfg(CFG_ODD))


@pytest.mark.parametrize("quant", ["int8", "int4", "w8a8"])
def test_zg2_qmm_off_takes_the_plain_routes(params, rng, monkeypatch, quant):
    """ZG2_QMM=0: no call reaches kernels.qmm through a forward (9-row and
    18-row linears) and an engine's prefill and decode steps; the logits
    equal the JAX package's under ZG2_QMM=0 (on the CPU its plain routes:
    the grouped matmul, w8a8_matmul, dequantize-then-matmul), and the
    greedy tokens the port's own with the kernel's plain version."""
    monkeypatch.setenv("ZG2_QMM", "0")
    jp, tp = _quantized(params, "int8" if quant == "w8a8" else quant)
    jcfg = dataclasses.replace(GPT2_NANO, act_quant=quant == "w8a8")
    tcfg = dataclasses.replace(TCFG, act_quant=quant == "w8a8")
    calls = []
    plain_qmm = tkernels.qmm

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain_qmm(*args, **kw)

    monkeypatch.setattr(tkernels, "qmm", counted)
    toks = rng.integers(0, GPT2_NANO.vocab_size, (2, 9))
    got = tgpt2.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    assert_logits_close(got, np.asarray(jgpt2.forward(jp, jnp.asarray(toks), jcfg)))
    kw = dict(max_seq=48, prompt_buckets=(16,))
    eng = InferenceEngine(tcfg, tp, device="cpu", **kw)
    tokens = [eng.generate(p, 8, GREEDY) for p in PROMPTS]
    assert calls == []
    monkeypatch.setenv("ZG2_QMM", "1")
    assert [eng.generate(p, 8, GREEDY) for p in PROMPTS] == tokens
    assert len(calls) > 0
    monkeypatch.setenv("ZG2_QMM", "2")
    with pytest.raises(ValueError, match="ZG2_QMM"):
        eng.generate(PROMPTS[0], 2, GREEDY)


def test_engine_cache_dtype_matches_jax(params, monkeypatch):
    """cache_dtype=bf16 on f32 weights: a bf16 cache, the JAX engine's
    tokens with the same cache dtype (its decode kernel, in interpret mode:
    f32 q and self-term over bf16 rows, as the port's plain version); the
    default stays wte's dtype."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    jp, tp = params
    kw = dict(max_seq=48, prompt_buckets=(16,))
    eng = InferenceEngine(TCFG, tp, device="cpu", cache_dtype=torch.bfloat16, **kw)
    assert eng.new_cache()["k"].dtype == torch.bfloat16
    assert InferenceEngine(TCFG, tp, device="cpu", **kw).new_cache()["k"].dtype == torch.float32
    jeng = JEngine(GPT2_NANO, jp, cache_dtype=jnp.bfloat16, **kw)
    for p in PROMPTS:
        assert eng.generate(p, 10, GREEDY) == jeng.generate(p, 10, JGREEDY)


def test_float_cache_dtype_codes():
    """The float-cache kernel takes q and the cache each in its own dtype:
    the wrapper's code is q's (0 f32, 1 bf16) plus twice the cache's, the
    four instantiations of ``csrc/decode_attention.cu``'s dispatch; an INT8
    cache adds nothing; any other cache dtype is refused."""
    f32, bf16 = torch.float32, torch.bfloat16
    for (q, c), code in {(f32, f32): 0, (bf16, f32): 1, (f32, bf16): 2, (bf16, bf16): 3,
                         (f32, torch.int8): 0, (bf16, torch.int8): 1}.items():
        assert tattention._dtype_code(q, c) == code
    with pytest.raises(ValueError, match="cache dtype"):
        tattention._dtype_code(f32, torch.float16)
