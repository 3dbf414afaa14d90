"""The port's continuous batcher (CPU) against the JAX package's.

Oracle: greedy decoding is deterministic, so a request streamed through the
port's ``ContinuousBatcher`` must give exactly the tokens that the JAX
``ContinuousBatcher`` gives it on the same weights: float and INT8 caches,
ring and linear (``ZG2_RING=0``), one and two slots, decode chunks of 1 and
4, and through the ring write pointer's wraparound. The INT8 runs hold the
JAX model to its deferred Pallas kernel in interpret mode
(``ZG2_FUSED_ATTN=interpret``), whose all-f32 arithmetic the port follows;
nano's head_dim of 32 keeps the JAX package on the unpacked layout. The
weights are GPT2_NANO's times 3, so that greedy streams differ per prompt.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.runtime.batcher import BatcherMetrics as JMetrics
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu_torch import cli as tcli
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.runtime.batcher import BatcherMetrics, ContinuousBatcher
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = tconfig.GPT2_NANO
GREEDY = SamplingConfig(temperature=0.0)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(lambda x: x * 3.0, jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(0)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _prompts(rng, lengths):
    return [[int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, n)] for n in lengths]


def _serve(batcher, prompts, max_new, **kw):
    rids = [batcher.submit(p, max_new, **kw) for p in prompts]
    done = batcher.run()
    assert len(done) == len(prompts) and all(r.done for r in done)
    by_rid = {r.rid: r.generated for r in done}
    return [by_rid[r] for r in rids]


def _both(params, monkeypatch, prompts, max_new, *, ring, kv_quant=None, **kw):
    """Greedy tokens per request from the JAX batcher and from the port's,
    and the port's batcher."""
    monkeypatch.setenv("ZG2_RING", "1" if ring else "0")
    if kv_quant:
        monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    jp, tp = params
    common = dict(max_seq=48, prompt_buckets=(16,), kv_quant=kv_quant, **kw)
    jb = JBatcher(GPT2_NANO, jp, sampling=JSampling(temperature=0.0), **common)
    tb = ContinuousBatcher(TCFG, tp, sampling=GREEDY, device="cpu", **common)
    assert jb._ring == tb._ring == ring and not jb.config.kv_packed
    return _serve(jb, prompts, max_new), _serve(tb, prompts, max_new), tb


@pytest.mark.parametrize("batch_size,decode_chunk", [(2, 1), (2, 4), (1, 1)],
                         ids=["b2-chunk1", "b2-chunk4", "b1-chunk1"])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "linear"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_greedy_tokens_identical_to_jax(params, rng, monkeypatch, kv_quant, ring,
                                        batch_size, decode_chunk):
    """Six requests of mixed lengths through the slots: slot reuse, lanes
    admitted at divergent positions, chunk overshoot discarded."""
    prompts = _prompts(rng, (3, 9, 5, 12, 7, 4))
    want, got, tb = _both(params, monkeypatch, prompts, 10, ring=ring, kv_quant=kv_quant,
                          batch_size=batch_size, decode_chunk=decode_chunk)
    assert got == want
    assert ("wptr" in tb.cache) == ring
    if kv_quant:
        assert tb.cache["k"].dtype == torch.int8


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_ring_wraparound_identical_to_jax(params, rng, monkeypatch, kv_quant):
    """12 requests x 12 tokens through one slot wrap the write pointer past
    the ring's R = 49 rows more than twice."""
    prompts = _prompts(rng, [4] * 12)
    want, got, tb = _both(params, monkeypatch, prompts, 12, ring=True, kv_quant=kv_quant,
                          batch_size=1)
    assert got == want
    rows = tb.cache["k"].shape[-2]
    assert rows == 49 and tb.metrics.steps > 2 * rows


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_batcher_matches_engine_and_stops(params, rng, kv_quant):
    """Each request's greedy tokens equal the port's single-stream engine's;
    a stop token ends the request and is not emitted."""
    _, tp = params
    prompts = _prompts(rng, (3, 9, 5, 12, 7))
    engine = InferenceEngine(TCFG, tp, max_seq=48, prompt_buckets=(16,), device="cpu",
                             kv_quant=kv_quant)
    want = [engine.generate(p, 8, GREEDY) for p in prompts]
    b = ContinuousBatcher(TCFG, tp, batch_size=2, max_seq=48, prompt_buckets=(16,),
                          sampling=GREEDY, kv_quant=kv_quant, device="cpu")
    assert _serve(b, prompts, 8) == want
    stop = want[1][4]
    got = _serve(b, prompts[1:2], 8, stop_tokens=[stop])
    assert got == [want[1][:want[1].index(stop)]]


def test_window_retirement_queue_and_streaming(params, rng):
    """A request without a budget retires at max_seq; five requests queue
    behind two slots; on_token streams each request's tokens in order, the
    two in flight interleaved."""
    _, tp = params
    events = []
    b = ContinuousBatcher(TCFG, tp, batch_size=2, max_seq=20, prompt_buckets=(16,),
                          sampling=GREEDY, device="cpu",
                          on_token=lambda rid, tok: events.append((rid, tok)))
    prompts = _prompts(rng, (15, 3, 7, 12, 5))
    rids = [b.submit(prompts[0])] + [b.submit(p, 6) for p in prompts[1:]]
    assert b.pending == 5
    first = b.step()
    assert set(first) == set(rids[:2]) and b.pending == 5
    done = b.run()
    assert b.pending == 0 and len(done) == 5
    by_rid = {r.rid: r.generated for r in done}
    assert len(by_rid[rids[0]]) == 20 - 15
    for rid in rids:
        assert [t for r, t in events if r == rid] == by_rid[rid]
    assert [r for r, _ in events[:2]] == rids[:2]
    m = b.metrics
    assert m.requests_finished == 5 and m.prefills == 5
    assert m.tokens_emitted == 5 + 4 * 6 == len(events)
    assert 0 < m.slot_utilization(2) <= 1 and len(m.sync_ms) == m.steps


def test_metrics_fields_match_jax():
    """The JAX batcher's fields, then the port's CUDA graph counters, which
    ``as_dict`` shows only once a graph was captured."""
    assert [f.name for f in dataclasses.fields(BatcherMetrics)] == \
        [f.name for f in dataclasses.fields(JMetrics)] + ["decode_graph_captures",
                                                         "decode_graph_replays"]
    t, j = BatcherMetrics(), JMetrics()
    for m in (t, j):
        m.steps, m.tokens_emitted, m.decode_s = 4, 8, 0.5
        m.sync_ms += [1.0, 3.0]
        m.request_latency_s += [0.25]
    assert t.as_dict(2) == j.as_dict(2)
    assert set(t.as_dict(2)) >= {"tokens_per_sec", "sync_ms_p50", "sync_ms_p99",
                                 "request_s_p50", "request_s_p99", "slot_utilization"}


def test_seeded_sampling_reproducible(params, rng):
    _, tp = params
    prompts = _prompts(rng, (3, 6, 4))

    def run(seed, chunk=1):
        s = SamplingConfig(temperature=0.8, top_k=40, top_p=0.9, seed=seed)
        b = ContinuousBatcher(TCFG, tp, batch_size=2, max_seq=48, prompt_buckets=(16,),
                              sampling=s, device="cpu", decode_chunk=chunk)
        return _serve(b, prompts, 10)

    a = run(5)
    assert a == run(5)
    assert a != run(6)
    assert all(len(t) == 10 for t in a)


def test_refuses_unported_options_and_missing_card(params):
    _, tp = params
    with pytest.raises(ValueError, match="prompt lookup only"):
        ContinuousBatcher(TCFG, tp, device="cpu", speculative="draft")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ContinuousBatcher(TCFG, tp, device="cpu", mesh="1x2")
    b = ContinuousBatcher(TCFG, tp, max_seq=32, prompt_buckets=(8,), device="cpu")
    with pytest.raises(ValueError, match="largest prompt bucket"):
        b.register_prefix(list(range(9)))
    with pytest.raises(ValueError, match="largest prompt bucket"):
        b.submit(list(range(9)))
    with pytest.raises(ValueError, match="max_seq"):
        b.submit(list(range(40)))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(TCFG, tp)


def test_cli_batch_file_greedy(tmp_path, capsys):
    """--batch-file over two slots: one JSON line per prompt, each the
    prompt's greedy completion on the same demo model."""
    prompts = ["the quick brown", "hello world, streaming", "the lazy dog", "fox"]
    f = tmp_path / "prompts.txt"
    f.write_text("\n".join(prompts) + "\n\n")
    argv = ["--demo", "--device", "cpu", "--batch-file", str(f), "--batch-slots", "2",
            "--temp", "0", "--max-tokens", "7", "--metrics"]
    tcli.main(argv)
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines()]
    assert sorted(d["prompt"] for d in lines) == sorted(prompts)
    assert json.loads(err)["requests_finished"] == 4
    config, encoder, params = tcli.demo_model(tcli.build_parser().parse_args(argv),
                                              torch.bfloat16)
    engine = InferenceEngine(config, params, encoder, device="cpu")
    for d in lines:
        want = engine.generate(encoder.encode(d["prompt"]), 7, GREEDY)
        assert d["completion"] == encoder.decode(want), d["prompt"]
