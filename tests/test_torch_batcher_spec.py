"""The port's speculative serving (``ContinuousBatcher(speculative="ngram")``,
CPU) against the JAX package's.

Oracle: greedy tokens. Each step runs ``spec_chunk`` rounds of prompt
lookup over each slot's token history and one (B, spec_k + 1) verify
extend, and commits the target's greedy tokens, so a request's tokens
equal the JAX speculative batcher's on the same weights, through slot
reuse, a stop token inside a round, ``spec_chunk`` 2 and 3, budgets
running out mid-round, a verify window wider than the w8a8 cap (16 x 5
rows) and the auto-off switch to plain decode; with a float cache they
also equal the port's plain batcher's. INT8 caches: extend's attention
rounds to bf16 in both packages, so the port is held to the JAX
speculative batcher there. The weights are GPT2_NANO's times 3, so that
greedy streams differ per prompt.
"""

import jax
import numpy as np
import pytest

from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.parallel.mesh import make_mesh
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = tconfig.GPT2_NANO
GREEDY, JGREEDY = SamplingConfig(temperature=0.0), JSampling(temperature=0.0)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(lambda x: x * 3.0, jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(0)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _serve(b, prompts, max_new, stop_tokens=()):
    rids = [b.submit(p, max_new, stop_tokens) for p in prompts]
    by = {r.rid: r.generated for r in b.run()}
    return [by[r] for r in rids]


def _port(params, **kw):
    return ContinuousBatcher(TCFG, params[1], max_seq=64, prompt_buckets=(16,),
                             sampling=kw.pop("sampling", GREEDY), device="cpu", **kw)


def _jax(params, **kw):
    return JBatcher(GPT2_NANO, params[0], max_seq=64, prompt_buckets=(16,), sampling=JGREEDY,
                    **kw)


def _prompts(rng, lengths):
    return [[int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, n)] for n in lengths]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_spec_serve_greedy_identical_to_jax_with_slot_reuse(params, rng, kv_quant):
    """Five requests through two slots; the metrics' speculative fields."""
    prompts = _prompts(rng, (3, 7, 5, 12, 9))
    kw = dict(batch_size=2, kv_quant=kv_quant, speculative="ngram", spec_k=3)
    tb = _port(params, **kw)
    assert not tb._ring and not tb.config.kv_packed and "wptr" not in tb.cache
    got = _serve(tb, prompts, 8)
    assert got == _serve(_jax(params, **kw), prompts, 8)
    if not kv_quant:
        assert got == _serve(_port(params, batch_size=2), prompts, 8)
    m = tb.metrics
    assert m.spec_rounds > 0 and m.spec_committed >= m.spec_slot_rounds > 0
    assert len(m.sync_ms) == m.spec_rounds and len(m.request_latency_s) == 5
    assert m.as_dict(2)["spec_rounds"] == m.spec_rounds


def test_spec_serve_wide_verify_window(params, rng):
    """16 slots, spec_k=4: 80-row verify extends; 20 requests."""
    prompts = [[int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, 3 + n % 9)]
               for n in range(20)]
    got = _serve(_port(params, batch_size=16, speculative="ngram", spec_k=4), prompts, 6)
    assert got == _serve(_port(params, batch_size=16), prompts, 6)
    assert got == _serve(_jax(params, batch_size=16, speculative="ngram", spec_k=4), prompts, 6)


def test_spec_serve_stop_token_mid_round(params, rng):
    """A stop token inside a round's committed tokens retires the slot and
    drops the overshoot: tokens end before the stop's first occurrence."""
    prompts = _prompts(rng, (6, 6, 6))
    base = _serve(_port(params, batch_size=2), prompts, 12)
    kw = dict(batch_size=2, speculative="ngram", spec_k=3)
    for p, w in zip(prompts, base):
        stop = w[2]
        got = _serve(_port(params, **kw), [p], 12, (stop,))
        assert got == _serve(_jax(params, **kw), [p], 12, (stop,))
        assert got[0] == w[:w.index(stop)]


def test_spec_serve_accepts_on_a_looping_stream(params):
    """Search seeded repeating prompts for one whose greedy stream loops;
    there lookup must commit more than one token per round, as the JAX
    batcher does."""
    looping = None
    for seed in range(8):
        prompt = [int(t) for t in np.random.default_rng(seed).integers(
            0, GPT2_NANO.vocab_size, 3)] * 5
        stream = _serve(_port(params, batch_size=1), [prompt], 24)[0]
        if stream[-3:] == stream[-6:-3] == stream[-9:-6]:
            looping = (prompt, stream)
            break
    assert looping is not None, "no seeded prompt gave a looping greedy stream"
    prompt, want = looping
    kw = dict(batch_size=1, speculative="ngram", spec_k=3, spec_ngram=2)
    tb, jb = _port(params, **kw), _jax(params, **kw)
    assert _serve(tb, [prompt], 24) == [want] == _serve(jb, [prompt], 24)
    assert 1.0 < tb.metrics.tokens_per_round <= 4.0
    assert tb.metrics.tokens_per_round == jb.metrics.tokens_per_round


@pytest.mark.parametrize("spec_chunk", [2, 3])
def test_spec_serve_chunked_rounds(params, rng, spec_chunk):
    prompts = _prompts(rng, (3, 7, 5, 12))
    kw = dict(batch_size=2, speculative="ngram", spec_k=2, spec_chunk=spec_chunk)
    tb = _port(params, **kw)
    got = _serve(tb, prompts, 8)
    assert got == _serve(_port(params, batch_size=2), prompts, 8)
    assert got == _serve(_jax(params, **kw), prompts, 8)
    assert tb.metrics.spec_rounds % spec_chunk == 0
    assert len(tb.metrics.sync_ms) == tb.metrics.spec_rounds // spec_chunk


def test_spec_serve_budget_exhaustion_and_refill(params, rng):
    prompts = _prompts(rng, (4, 4, 4, 4, 4))
    kw = dict(batch_size=2, speculative="ngram", spec_k=3)
    got = _serve(_port(params, **kw), prompts, 5)
    assert all(len(g) == 5 for g in got)
    assert got == _serve(_jax(params, **kw), prompts, 5)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_spec_serve_randomized_lifecycle(params, kv_quant):
    """Twelve requests of random lengths (one token included), budgets
    (one included) and stop tokens through three slots, spec_chunk 2."""
    r = np.random.default_rng(42)
    reqs = []
    for _ in range(12):
        prompt = [int(t) for t in r.integers(0, GPT2_NANO.vocab_size, int(r.integers(1, 15)))]
        stops = tuple(int(t) for t in r.integers(0, GPT2_NANO.vocab_size,
                                                   int(r.integers(0, 3))))
        reqs.append((prompt, int(r.integers(1, 10)), stops))

    def run(b):
        rids = [b.submit(p, m, s) for p, m, s in reqs]
        by = {q.rid: q.generated for q in b.run()}
        return [by[i] for i in rids]

    kw = dict(batch_size=3, kv_quant=kv_quant, speculative="ngram", spec_k=2, spec_chunk=2)
    got = run(_port(params, **kw))
    assert got == run(_jax(params, **kw))
    if not kv_quant:
        assert got == run(_port(params, batch_size=3))


def test_spec_serve_sampled_runs(params, rng):
    """Sampled prompt lookup: every request gets its budget; seeded runs
    repeat and other seeds differ."""
    prompts = _prompts(rng, (5, 5, 5))

    def run(seed):
        b = _port(params, batch_size=2, speculative="ngram", spec_k=2,
                  sampling=SamplingConfig(temperature=0.8, seed=seed))
        return _serve(b, prompts, 6)

    a = run(1)
    assert all(len(t) == 6 for t in a) and a == run(1) and a != run(2)


def test_spec_serve_auto_off_and_telemetry(params, rng):
    """An impossible spec_min_tpr switches to plain decode mid-run: tokens
    stay those of plain serving and of the JAX batcher, and the switch
    lands on the JAX batcher's step; with 0 the switch never fires."""
    prompts = [[int(t) for t in rng.integers(0, GPT2_NANO.vocab_size, 4 + n % 7)]
               for n in range(24)]
    want = _serve(_port(params, batch_size=8), prompts, 12)
    kw = dict(batch_size=8, speculative="ngram", spec_k=3, spec_min_tpr=100.0)
    tb, jb = _port(params, **kw), _jax(params, **kw)
    assert _serve(tb, prompts, 12) == want == _serve(jb, prompts, 12)
    m = tb.metrics
    assert m.spec_auto_off_step is not None
    assert m.spec_auto_off_step == jb.metrics.spec_auto_off_step
    assert m.as_dict(8)["spec_auto_off_step"] == m.spec_auto_off_step
    full = _port(params, batch_size=8, speculative="ngram", spec_k=3, spec_min_tpr=0.0)
    assert _serve(full, prompts, 12) == want
    assert full.metrics.spec_auto_off_step is None
    assert m.spec_slot_rounds < full.metrics.spec_slot_rounds


def test_spec_serve_constructor_guards(params):
    with pytest.raises(ValueError, match="decode_chunk"):
        _port(params, batch_size=2, speculative="ngram", decode_chunk=4)
    with pytest.raises(ValueError, match="prompt lookup"):
        _port(params, batch_size=2, speculative="124M")
    with pytest.raises(ValueError, match="spec_k"):
        _port(params, batch_size=2, speculative="ngram", spec_k=0)
    # Served under a mesh (tests/test_torch_tp_spec.py): the rank's config
    # follows the JAX op-level program, its cache unpacked.
    served = _port(params, batch_size=2, speculative="ngram", mesh=make_mesh(1, 1, "cpu"))
    assert served.config.op_level and not served.config.kv_packed


def test_cli_batch_file_ngram_speculation(tmp_path, capsys):
    """--draft-model ngram with --batch-file: prompt-lookup serving, two
    rounds per sync (--decode-chunk 2); completions are the plain
    engine's greedy ones, and the metrics show the rounds."""
    import json

    import torch

    from zig_gpt2_tpu_torch import cli as tcli
    from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine

    prompts = ["the quick brown", "hello world, streaming", "the lazy dog"]
    f = tmp_path / "prompts.txt"
    f.write_text("\n".join(prompts) + "\n")
    argv = ["--demo", "--device", "cpu", "--batch-file", str(f), "--batch-slots", "2",
            "--draft-model", "ngram", "--spec-k", "3", "--decode-chunk", "2", "--temp", "0",
            "--max-tokens", "7", "--metrics"]
    tcli.main(argv)
    out, err = capsys.readouterr()
    assert json.loads(err)["spec_rounds"] > 0
    config, encoder, tparams = tcli.demo_model(tcli.build_parser().parse_args(argv),
                                               torch.bfloat16)
    engine = InferenceEngine(config, tparams, encoder, device="cpu")
    for d in map(json.loads, out.splitlines()):
        want = engine.generate(encoder.encode(d["prompt"]), 7, GREEDY)
        assert d["completion"] == encoder.decode(want), d["prompt"]
