"""The port's ``SpeculativeEngine`` (CPU) against the JAX package's.

Greedy: the emitted tokens are the target's greedy tokens, whatever the
draft and k, so the port's must equal the JAX ``SpeculativeEngine``'s on
the same weights, for a draft model and for prompt lookup, k 1, 3 and 5,
an INT8-weight target with an INT8 or float cache and an INT8 draft cache,
and (where both sides run the same attention arithmetic: a float target
cache, since the port's INT8 decode follows the all-f32 kernel and extend
the bf16 rounding) the port's own ``InferenceEngine``'s. The round count
hits its ceiling for a self-draft and for a looping stream.

Sampled: the port draws from a ``torch.Generator``, the JAX package from
``jax.random``, so tokens match in law only. The first emitted token's
empirical law over 3000 lanes is held against the target's exact law (the
mixture over the prefill's draw), with temperature and with top-k, as the
JAX package's own test does, at 4 binomial sigma plus 0.01.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_gpt2_tpu.config import GPTConfig, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu.runtime.speculative import SpeculativeEngine as JSpec
from zig_gpt2_tpu.runtime.speculative import _propose_ngram as jpropose
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.runtime import speculative as tspec
from zig_gpt2_tpu_torch.runtime.engine import GenerationMetrics, InferenceEngine
from zig_gpt2_tpu_torch.runtime.sampling import _mask_logits
from zig_gpt2_tpu_torch.runtime.speculative import SpeculativeEngine
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = GPTConfig(vocab_size=512, context_size=128, n_layers=2, n_heads=4, n_embed=128)
DCFG = GPTConfig(vocab_size=512, context_size=128, n_layers=1, n_heads=2, n_embed=64)
GREEDY, JGREEDY = SamplingConfig(temperature=0.0), JSampling(temperature=0.0)
B, P, S = 2, 8, 24
LENS = [P, 5]


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


def _params(cfg, seed, scale=3.0):
    """JAX params (x ``scale``, so that greedy streams are diverse) and the
    port's copy."""
    jp = jax.tree.map(lambda x: x * scale, jgpt2.init_params(cfg, jax.random.PRNGKey(seed)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def target():
    return _params(TCFG, 0)


@pytest.fixture(scope="module")
def draft():
    return _params(DCFG, 1)


def _prompts(b=B, n=P):
    return np.random.default_rng(0).integers(0, TCFG.vocab_size, (b, n)).astype(np.int32)


def _engine_ref(tp, **kw):
    return InferenceEngine(_tcfg(TCFG), tp, batch_size=B, max_seq=64, prompt_buckets=(P,),
                           device="cpu", **kw).generate_scan(_prompts(), LENS, S, GREEDY)


def _specs(jt, tt, jd=None, td=None, **kw):
    common = dict(batch_size=B, max_seq=64, prompt_buckets=(P,), **kw)
    dcfg = DCFG if jd is not None else None
    return (JSpec(TCFG, jt, dcfg, jd, **common),
            SpeculativeEngine(_tcfg(TCFG), tt, dcfg and _tcfg(dcfg), td, device="cpu", **common))


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("mode", ["draft", "ngram"])
def test_greedy_identical_to_jax_and_engine(target, draft, mode, k):
    (jt, tt), (jd, td) = target, draft
    js, ts = _specs(jt, tt, *((jd, td) if mode == "draft" else ()), k=k)
    want = js.generate_scan(_prompts(), LENS, S, JGREEDY)
    got = ts.generate_scan(_prompts(), LENS, S, GREEDY)
    assert len(set(want[0].tolist())) > 3  # the stream is not degenerate
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _engine_ref(tt))
    assert ts.acceptance_stats == {"rounds": ts.last_rounds, "k": k}
    assert -(-S // (k + 1)) <= ts.last_rounds <= S


@pytest.mark.parametrize("kv_quant,draft_kv", [("int8", None), ("int8", "int8"), (None, "int8")],
                         ids=["int8kv", "int8kv-int8draft", "floatkv-int8draft"])
def test_greedy_quantized_target_identical_to_jax(target, draft, kv_quant, draft_kv):
    """An INT8-weight target (INT8 or float cache) and a float or INT8
    draft cache, k=3: tokens equal the JAX engine's and, with a float
    target cache, the port's own engine's."""
    (jt, _), (jd, td) = target, draft
    jtq = jq.quantize_params(jt, mode="int8")
    ttq = params_from_numpy(jax.tree.map(np.asarray, jtq))
    js, ts = _specs(jtq, ttq, jd, td, k=3, kv_quant=kv_quant, draft_kv_quant=draft_kv)
    got = ts.generate_scan(_prompts(), LENS, 16, GREEDY)
    np.testing.assert_array_equal(got, js.generate_scan(_prompts(), LENS, 16, JGREEDY))
    assert ts.draft_kv_quant == draft_kv and ("k_scale" in ts._new_cache(False)) == bool(draft_kv)
    if kv_quant is None:
        np.testing.assert_array_equal(got, _engine_ref(ttq)[:, :16])


def test_self_draft_hits_the_ceiling(target):
    """Draft == target: every proposal is accepted, the round count is
    ceil(S / (k + 1)) and every round takes the pend/pv catch-up."""
    _, tt = target
    k = 4
    ts = SpeculativeEngine(_tcfg(TCFG), tt, _tcfg(TCFG), tt, k=k, batch_size=B, max_seq=64,
                           prompt_buckets=(P,), device="cpu")
    np.testing.assert_array_equal(ts.generate_scan(_prompts(), LENS, S, GREEDY), _engine_ref(tt))
    assert ts.last_rounds == -(-S // (k + 1))


def test_ngram_loop_hits_the_ceiling():
    """Unscaled random weights collapse to a fixed point: prompt lookup
    rides the loop at full acceptance, as the JAX engine does."""
    k = 4
    jp, tp = _params(TCFG, 0, scale=1.0)
    prompts = _prompts(1)
    js = JSpec(TCFG, jp, k=k, batch_size=1, max_seq=64, prompt_buckets=(P,))
    ts = SpeculativeEngine(_tcfg(TCFG), tp, k=k, batch_size=1, max_seq=64, prompt_buckets=(P,),
                           device="cpu")
    want = js.generate_scan(prompts, [P], S, JGREEDY)
    assert len(set(want[0, 4:].tolist())) == 1  # the stream is a loop
    np.testing.assert_array_equal(ts.generate_scan(prompts, [P], S, GREEDY), want)
    assert ts.last_rounds == js.last_rounds == -(-S // (k + 1))


def test_propose_ngram_matches_jax(rng):
    """Prompt-lookup proposals on random histories of a 3-token alphabet
    (many matches, short ones, none), lengths 1 to C."""
    C, k = 24, 5
    for ngram in (1, 2, 3):
        hist = rng.integers(0, 3, (16, C)).astype(np.int32)
        hist_len = rng.integers(1, C + 1, 16).astype(np.int32)
        tok = hist[np.arange(16), hist_len - 1]
        want = jpropose(jnp.asarray(hist), jnp.asarray(hist_len), jnp.asarray(tok), k=k,
                        ngram=ngram)
        got = tspec._propose_ngram(torch.from_numpy(hist), torch.from_numpy(hist_len),
                                   torch.from_numpy(tok), k=k, ngram=ngram)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_iter_matches_scan_engine_and_stops(target, draft):
    """The streaming iterator yields the prefill's token and then the scan's
    stream, equal to the engine's; a stop token ends it; metrics count."""
    (_, tt), (_, td) = target, draft
    prompt = [int(t) for t in _prompts(1)[0]]
    ts = SpeculativeEngine(_tcfg(TCFG), tt, _tcfg(DCFG), td, k=3, max_seq=64,
                           prompt_buckets=(P,), device="cpu")
    m = GenerationMetrics()
    it = ts.generate(prompt, 17, GREEDY, metrics=m)
    assert m.generated_tokens == 17 and m.prompt_tokens == P and ts.last_rounds >= 1
    eng = InferenceEngine(_tcfg(TCFG), tt, max_seq=64, prompt_buckets=(P,), device="cpu")
    assert it == eng.generate(prompt, 17, GREEDY)
    scan = ts.generate_scan(np.asarray([prompt], np.int32), [P], 17, GREEDY)[0]
    np.testing.assert_array_equal(scan[:-1], np.asarray(it[1:]))
    stop = it[5]
    assert ts.generate(prompt, 17, GREEDY, stop_tokens=[stop]) == it[:it.index(stop)]


def test_packed_draft_greedy_identical_to_engine(monkeypatch):
    """ZG2_SPEC_DRAFT_PACKED=1 (with ZG2_KV_PACKED=1, where the CPU may
    pack): the draft's cache is head-pair packed (three heads of 64, the
    phantom head padded in), the target's unpacked; tokens equal the JAX
    engine's with a packed draft and the port's engine's."""
    tcfg = GPTConfig(vocab_size=512, context_size=128, n_layers=2, n_heads=4, n_embed=256)
    dcfg = GPTConfig(vocab_size=512, context_size=128, n_layers=1, n_heads=3, n_embed=192)
    jt, tt = _params(tcfg, 0)
    jd, td = _params(dcfg, 1)
    kw = dict(k=3, batch_size=B, max_seq=64, prompt_buckets=(P,), draft_kv_quant="int8")
    monkeypatch.setenv("ZG2_SPEC_DRAFT_PACKED", "1")
    monkeypatch.setenv("ZG2_KV_PACKED", "1")
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    ts = SpeculativeEngine(_tcfg(tcfg), tt, _tcfg(dcfg), td, device="cpu", **kw)
    assert ts.draft_config.kv_packed and ts.draft_config.attn_heads == 4
    assert not ts.config.kv_packed
    got = ts.generate_scan(_prompts(), LENS, 16, GREEDY)
    js = JSpec(tcfg, jt, dcfg, jd, **kw)
    assert js.draft_config.kv_packed
    np.testing.assert_array_equal(got, js.generate_scan(_prompts(), LENS, 16, JGREEDY))
    monkeypatch.setenv("ZG2_KV_PACKED", "0")
    eng = InferenceEngine(_tcfg(tcfg), tt, batch_size=B, max_seq=64, prompt_buckets=(P,),
                          device="cpu")
    np.testing.assert_array_equal(got, eng.generate_scan(_prompts(), LENS, 16, GREEDY))


def _first_token_law(tp, tcfg, prompts, temp, top_k):
    """The exact law of the first emitted token: the prefill's draw t0,
    then the target's law after [prompt, t0], mixed over t0."""
    def law(logits):
        return torch.softmax(_mask_logits(logits.float() / temp, top_k, None), -1)[0].numpy()

    cache = tgpt2.init_kv_cache(tcfg, 1, 32)
    cache, lg0 = tgpt2.prefill(tp, cache, torch.from_numpy(prompts),
                               torch.tensor([prompts.shape[1]], dtype=torch.int32), tcfg)
    p_t0 = law(lg0)
    mix = np.zeros(tcfg.vocab_size)
    for t0 in np.flatnonzero(p_t0):
        c = {name: t.clone() for name, t in cache.items()}
        _, lg1 = tgpt2.decode_step(tp, c, torch.tensor([t0], dtype=torch.int32), tcfg)
        mix += p_t0[t0] * law(lg1)
    return mix


@pytest.mark.parametrize("top_k,slack", [(None, 0.01), (4, 0.012)], ids=["temperature", "top-k"])
def test_sampled_first_token_follows_the_target_law(top_k, slack):
    """One round with k=2 and a different draft (accept, residual and bonus
    paths), over 3 x 1000 lanes with their own draws: the first emitted
    token's empirical law against the target's exact law, and no token
    outside the top-k support."""
    vocab, temp, lanes = 16, 0.9, 1000
    cfg = GPTConfig(vocab_size=vocab, context_size=32, n_layers=1, n_heads=2, n_embed=32)
    _, tp = _params(cfg, 2, scale=2.0)
    _, dp = _params(cfg, 3, scale=2.0)
    tcfg = _tcfg(cfg)
    prompts = (np.arange(4, dtype=np.int32) % vocab)[None]
    mix = _first_token_law(tp, tcfg, prompts, temp, top_k)
    spec = SpeculativeEngine(tcfg, tp, tcfg, dp, k=2, batch_size=lanes, max_seq=32,
                             prompt_buckets=(4,), device="cpu")
    counts = np.zeros(vocab)
    for seed in range(3):
        out = spec.generate_scan(np.repeat(prompts, lanes, 0), [4] * lanes, 1,
                                 SamplingConfig(temperature=temp, top_k=top_k, seed=seed))
        counts += np.bincount(out[:, 0], minlength=vocab)
    n = 3 * lanes
    emp = counts / n
    assert np.all(counts[mix == 0.0] == 0)
    tol = 4 * np.sqrt(np.maximum(mix * (1 - mix), 1e-4) / n)
    assert np.all(np.abs(emp - mix) < tol + slack), (emp, mix)


def test_ngram_sampled_runs_and_guards(target):
    """Sampled prompt lookup (one-hot Q): the whole budget, seeded
    reproducibly, different across seeds; the constructor's guards."""
    _, tt = target
    spec = SpeculativeEngine(_tcfg(TCFG), tt, k=3, batch_size=1, max_seq=64,
                             prompt_buckets=(P,), device="cpu")
    run = [spec.generate_scan(_prompts(1), [P], 16, SamplingConfig(temperature=0.9, seed=s))
           for s in (0, 0, 1)]
    assert run[0].shape == (1, 16)
    np.testing.assert_array_equal(run[0], run[1])
    assert not np.array_equal(run[0], run[2])
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeEngine(_tcfg(TCFG), tt, k=0, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        spec.generate_scan(_prompts(1), [P], 64, GREEDY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpeculativeEngine(_tcfg(TCFG), tt)


@pytest.mark.parametrize("draft", ["demo", "ngram"])
def test_cli_draft_model_greedy(capsys, draft):
    """--draft-model (a small random draft on the demo tokenizer, or prompt
    lookup): the streamed text is the plain engine's greedy text."""
    from zig_gpt2_tpu_torch import cli as tcli

    argv = ["--demo", "--device", "cpu", "--draft-model", draft, "--spec-k", "3",
            "--draft-kv-quant", "--temp", "0", "--max-tokens", "10", "--metrics", "the quick"]
    tcli.main(argv)
    out, err = capsys.readouterr()
    metrics = json.loads(err)
    assert metrics["generated_tokens"] == 10 and metrics["draft"] == draft
    config, encoder, tparams = tcli.demo_model(tcli.build_parser().parse_args(argv),
                                               torch.bfloat16)
    engine = InferenceEngine(config, tparams, encoder, device="cpu")
    want = engine.generate_text("the quick", 10, GREEDY)
    assert out == "the quick" + want + "\n"
