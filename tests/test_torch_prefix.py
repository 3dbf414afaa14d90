"""Prefix caching in the port (CPU) against the JAX package's: the engine's
and the continuous batcher's ``register_prefix``.

Oracle: greedy tokens. A prompt that shares leading tokens with a
registered prefix starts from the stored rows and runs only its suffix
(one ``gpt2.extend``), so the port's tokens must equal the JAX package's
with the same prefix registered, through full hits, a one-token suffix,
prompt == prefix (len - 1 rows reused), a partial overlap, misses and
slot reuse; and with a float cache they equal the port's own tokens
without a prefix. INT8 caches run the JAX model under
``ZG2_FUSED_ATTN=interpret`` (its all-f32 decode kernel, which the port
follows; extend's attention rounds to bf16 in both packages). The weights
are GPT2_NANO's times 3, so that greedy streams differ per prompt.
"""

import json

import jax
import numpy as np
import pytest
import torch

from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu.runtime.engine import match_prefix as jmatch_prefix
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.runtime.engine import GenerationMetrics, InferenceEngine, match_prefix
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = tconfig.GPT2_NANO
GREEDY = SamplingConfig(temperature=0.0)
JGREEDY = JSampling(temperature=0.0)
PREFIX = [41, 7, 13, 29, 3, 17, 23, 11]  # the "system prompt"


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(lambda x: x * 3.0, jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(0)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _engine_prompts(rng):
    return [PREFIX + [int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, 4)],  # hit
            list(PREFIX),  # prompt == prefix: len - 1 rows reused
            PREFIX[:5] + [9, 9],  # partial overlap
            [int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, 5)]]  # miss


def test_match_prefix_matches_jax(rng):
    """The one matching policy, on random prompts, prefixes, buckets and
    cache sizes (the bucket-fit shrink included)."""
    for _ in range(300):
        prefixes = [(tuple(int(t) for t in rng.integers(0, 3, int(rng.integers(1, 9)))), None)
                    for _ in range(int(rng.integers(1, 4)))]
        prompt = [int(t) for t in rng.integers(0, 3, int(rng.integers(1, 12)))]
        buckets = tuple(sorted({int(b) for b in rng.integers(1, 16, 3)} | {16}))
        rows = int(rng.integers(8, 24))
        assert match_prefix(prefixes, prompt, buckets, rows) == jmatch_prefix(
            prefixes, prompt, buckets, rows)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("decode_chunk", [1, 4], ids=["chunk1", "chunk4"])
def test_engine_prefix_greedy_identical_to_jax(params, rng, monkeypatch, decode_chunk,
                                               kv_quant):
    if kv_quant:
        monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    jp, tp = params
    kw = dict(max_seq=64, prompt_buckets=(16,), decode_chunk=decode_chunk, kv_quant=kv_quant)
    jeng, teng = JEngine(GPT2_NANO, jp, **kw), InferenceEngine(TCFG, tp, device="cpu", **kw)
    jeng.register_prefix(PREFIX)
    teng.register_prefix(PREFIX)
    plain = InferenceEngine(TCFG, tp, device="cpu", **kw)
    for prompt in _engine_prompts(rng):
        got = teng.generate(prompt, 8, GREEDY)
        assert got == jeng.generate(prompt, 8, JGREEDY), prompt
        if not kv_quant:  # a float cache: the hit's rows are the miss's rows
            assert got == plain.generate(prompt, 8, GREEDY), prompt
    # The stored rows survive every hit.
    prompt = _engine_prompts(rng)[0]
    assert teng.generate(prompt, 8, GREEDY) == jeng.generate(prompt, 8, JGREEDY)


def test_engine_prefix_metrics_and_validation(params, rng):
    _, tp = params
    eng = InferenceEngine(TCFG, tp, max_seq=64, prompt_buckets=(16,), device="cpu")
    eng.register_prefix(PREFIX)
    m = GenerationMetrics()
    eng.generate(PREFIX + [5, 6], 4, GREEDY, metrics=m)
    assert m.prefix_tokens_reused == len(PREFIX) and m.generated_tokens == 4
    m2 = GenerationMetrics()
    eng.generate([int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, 4)], 4, GREEDY,
                 metrics=m2)
    assert m2.prefix_tokens_reused == 0
    with pytest.raises(ValueError):
        eng.register_prefix([])
    with pytest.raises(ValueError):
        eng.register_prefix(list(range(17)))  # past the largest bucket
    with pytest.raises(ValueError, match="single-sequence"):
        InferenceEngine(TCFG, tp, batch_size=2, max_seq=64, prompt_buckets=(16,),
                        device="cpu").register_prefix(PREFIX)


def _batcher_prompts(rng):
    vocab = GPT2_NANO.vocab_size
    return [PREFIX + [int(t) for t in rng.integers(0, vocab, 4)],  # full hit
            PREFIX + [2],  # a one-token suffix
            list(PREFIX),  # prompt == prefix
            PREFIX[:5] + [9, 9, 9],  # partial overlap
            [int(t) for t in rng.integers(0, vocab, 6)],  # miss
            PREFIX + [int(t) for t in rng.integers(0, vocab, 7)]]  # a hit refilling a slot


def _serve(b, prompts, max_new, prefixes=()):
    for pre in prefixes:
        b.register_prefix(pre)
    rids = [b.submit(p, max_new) for p in prompts]
    by = {r.rid: r.generated for r in b.run()}
    return [by[r] for r in rids]


def _batchers(params, monkeypatch, ring, kv_quant, **kw):
    monkeypatch.setenv("ZG2_RING", "1" if ring else "0")
    if kv_quant:
        monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    jp, tp = params
    common = dict(batch_size=2, max_seq=64, prompt_buckets=(16,), kv_quant=kv_quant, **kw)
    return (JBatcher(GPT2_NANO, jp, sampling=JGREEDY, **common),
            ContinuousBatcher(TCFG, tp, sampling=GREEDY, device="cpu", **common),
            ContinuousBatcher(TCFG, tp, sampling=GREEDY, device="cpu", **common))


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "linear"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_batcher_prefix_greedy_identical_to_jax(params, rng, monkeypatch, kv_quant, ring):
    """Six requests through two slots; the hits admit as prefix groups (the
    ring rotates each spliced lane to end at the write row)."""
    prompts = _batcher_prompts(rng)
    jb, tb, plain = _batchers(params, monkeypatch, ring, kv_quant)
    assert tb._ring == ring and ("wptr" in tb.cache) == ring
    got = _serve(tb, prompts, 8, [PREFIX])
    assert got == _serve(jb, prompts, 8, [PREFIX])
    if not kv_quant:
        assert got == _serve(plain, prompts, 8)
    m = tb.metrics
    assert m.prefix_hits == jb.metrics.prefix_hits == 5
    assert m.prefill_tokens_saved == jb.metrics.prefill_tokens_saved == 8 + 8 + 7 + 5 + 8
    assert m.as_dict(2)["prefix_hits"] == 5


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "linear"])
def test_longest_prefix_wins(params, rng, monkeypatch, ring):
    """Two registered prefixes, one extending the other: the longer match
    is taken (more rows saved); tokens equal the JAX batcher's and the
    port's without a prefix."""
    long_pre = PREFIX + [5, 6]
    prompts = [long_pre + [1, 2], PREFIX + [9], long_pre + [4]]
    jb, tb, plain = _batchers(params, monkeypatch, ring, None)
    got = _serve(tb, prompts, 6, [PREFIX, long_pre])
    assert got == _serve(jb, prompts, 6, [PREFIX, long_pre]) == _serve(plain, prompts, 6)
    assert tb.metrics.prefill_tokens_saved == 10 + 8 + 10


def test_prefix_reuse_across_many_requests_and_ring_wrap(params, rng, monkeypatch):
    """Twelve hits through one slot of a ring of R = 49 rows: the write
    pointer wraps and every spliced lane continues across it; the stored
    rows survive every hit."""
    prompts = [PREFIX + [int(t)] for t in rng.integers(0, GPT2_NANO.vocab_size, 12)]
    monkeypatch.setenv("ZG2_RING", "1")
    _, tp = params
    kw = dict(batch_size=1, max_seq=48, prompt_buckets=(16,), sampling=GREEDY, device="cpu")
    tb = ContinuousBatcher(TCFG, tp, **kw)
    got = _serve(tb, prompts, 8, [PREFIX])
    assert got == _serve(ContinuousBatcher(TCFG, tp, **kw), prompts, 8)
    assert tb.metrics.prefix_hits == 12 and tb.metrics.prefill_tokens_saved == 12 * 8
    assert tb.cache["k"].shape[-2] == 49 and tb.metrics.steps > 49


def test_batcher_prefix_with_speculative_serving(params, rng, monkeypatch):
    """Prefix hits under prompt-lookup serving: the history of a hit's slot
    holds the whole prompt; tokens equal the JAX batcher's and plain
    serving's."""
    prompts = _batcher_prompts(rng)
    jb, tb, plain = _batchers(params, monkeypatch, False, None, speculative="ngram", spec_k=2,
                              spec_chunk=2)
    got = _serve(tb, prompts, 8, [PREFIX])
    assert got == _serve(jb, prompts, 8, [PREFIX])
    monkeypatch.setenv("ZG2_RING", "1")
    _, tp = params
    assert got == _serve(ContinuousBatcher(TCFG, tp, batch_size=2, max_seq=64,
                                           prompt_buckets=(16,), sampling=GREEDY,
                                           device="cpu"), prompts, 8)
    assert tb.metrics.prefix_hits == 5 and tb.metrics.spec_rounds > 0


def test_batcher_register_prefix_validation(params):
    _, tp = params
    b = ContinuousBatcher(TCFG, tp, batch_size=2, max_seq=64, prompt_buckets=(16,),
                          sampling=GREEDY, device="cpu")
    with pytest.raises(ValueError):
        b.register_prefix([])
    with pytest.raises(ValueError, match="largest prompt bucket"):
        b.register_prefix(list(range(17)))


def test_cli_batch_file_with_prefix(tmp_path, capsys):
    """--batch-file --prefix: the prompts that start with the prefix admit
    from its stored rows (prefix_hits in the metrics) and complete as the
    plain engine's greedy tokens."""
    from zig_gpt2_tpu_torch import cli as tcli

    prompts = ["the quick brown fox", "the quick brown dog", "hello world", "the quick"]
    f = tmp_path / "prompts.txt"
    f.write_text("\n".join(prompts) + "\n")
    argv = ["--demo", "--device", "cpu", "--batch-file", str(f), "--batch-slots", "2",
            "--prefix", "the quick brown", "--temp", "0", "--max-tokens", "6", "--metrics"]
    tcli.main(argv)
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines()]
    assert json.loads(err)["prefix_hits"] >= 2
    config, encoder, tparams = tcli.demo_model(tcli.build_parser().parse_args(argv),
                                               torch.bfloat16)
    engine = InferenceEngine(config, tparams, encoder, device="cpu")
    for d in lines:
        want = engine.generate(encoder.encode(d["prompt"]), 6, GREEDY)
        assert d["completion"] == encoder.decode(want), d["prompt"]
