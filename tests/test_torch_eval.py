"""The port's perplexity harness and ppl_gate tool (CPU) against the JAX
package's (``eval/perplexity.py``, ``tools/ppl_gate.py``).

Tolerances: fp32 perplexity within 1e-5 relative of the JAX package's on
the same weights and tokens (the same f32 forward summed in another
order); quantized within 1e-4 relative (the port's CPU linears are its
GEMV kernels' plain versions, which scale each weight before the sum,
where the JAX package's CPU path scales per-group partial sums; the
w8a8 products are the same integers in both). The cases of
``tests/test_eval.py`` run on the port as they are written there.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
import zig_gpt2_tpu.eval.perplexity as jev
from zig_gpt2_tpu.config import GPT2_MICRO, GPT2_NANO
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu.tools import ppl_gate as jtool
import zig_gpt2_tpu_torch.eval.perplexity as ev
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.quant import quantize as tq
from zig_gpt2_tpu_torch.tools import ppl_gate as ttool
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = tconfig.GPT2_NANO
QUANT_RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_random_model_ppl_near_vocab(params, rng):
    """An untrained (near-uniform-logit) model's perplexity is about V."""
    ids = rng.integers(0, GPT2_NANO.vocab_size, 2000)
    ppl = ev.perplexity(params[1], TCFG, ids, window=64, batch_size=4)
    assert 0.5 * GPT2_NANO.vocab_size < ppl < 2.0 * GPT2_NANO.vocab_size


def test_ppl_matches_manual_single_window(params, rng):
    ids = rng.integers(0, GPT2_NANO.vocab_size, 64)
    ppl = ev.perplexity(params[1], TCFG, ids, window=64, batch_size=1)
    logits = tgpt2.forward(params[1], torch.from_numpy(ids[None, :]), TCFG)
    logp = torch.log_softmax(logits[0, :-1].float(), -1).numpy()
    nll = -logp[np.arange(63), ids[1:]].mean()
    assert math.isclose(ppl, math.exp(nll), rel_tol=1e-4)


def test_padded_tail_excluded(params, rng):
    """100 ids in windows of 64: the tail window (36 ids, 35 targets) is
    padded and its padding never scored; the padded chunk rows neither."""
    ids = rng.integers(0, GPT2_NANO.vocab_size, 100)
    ppl = ev.perplexity(params[1], TCFG, ids, window=64, batch_size=4)
    nll = 0.0
    for part in (ids[:64], ids[64:]):
        logits = tgpt2.forward(params[1], torch.from_numpy(part[None, :]), TCFG)
        logp = torch.log_softmax(logits[0, :-1].double(), -1).numpy()
        nll += -logp[np.arange(part.size - 1), part[1:]].sum()
    assert math.isclose(ppl, math.exp(nll / 98), rel_tol=1e-5)


def test_quantized_ppl_gate_nano(params, rng):
    ids = rng.integers(0, GPT2_NANO.vocab_size, 1000)
    passed, p_fp, p_q = ev.ppl_gate(params[1], tq.quantize_params(params[1], "int8"), TCFG,
                                    ids, budget=0.05 * GPT2_NANO.vocab_size, window=64,
                                    batch_size=4)
    assert passed, (p_fp, p_q)
    assert abs(p_q - p_fp) / p_fp < 0.01, (p_fp, p_q)


def test_load_tokens_roundtrip(tmp_path, rng):
    ids = rng.integers(0, 1000, 64).astype(np.int32)
    np.save(tmp_path / "corpus.npy", ids)
    np.testing.assert_array_equal(ev.load_tokens(str(tmp_path / "corpus.npy")), ids)
    ids.tofile(tmp_path / "corpus.bin")
    np.testing.assert_array_equal(ev.load_tokens(str(tmp_path / "corpus.bin")), ids)
    (tmp_path / "corpus.txt").write_text("hello")
    with pytest.raises(ValueError, match="tokenizer"):
        ev.load_tokens(str(tmp_path / "corpus.txt"))


@pytest.mark.parametrize("mode", ["fp32", "int8", "int4", "w8a8"])
@pytest.mark.parametrize("window,batch", [(64, 4), (128, 3)], ids=["gemv", "matmul"])
def test_perplexity_matches_jax(params, rng, mode, window, batch):
    """300 ids, a padded tail and padded chunk rows; 256 rows per batch
    (the GEMV path of quantized linears: ``qmm``'s plain version, w8a8's up
    to 64 rows) or 384 (dequantize-then-matmul, ``w8a8_matmul``)."""
    jp, tp = params
    jcfg, tcfg = GPT2_NANO, TCFG
    if mode != "fp32":
        wmode = "int8" if mode == "w8a8" else mode
        jp, tp = jq.quantize_params(jp, mode=wmode), tq.quantize_params(tp, mode=wmode)
        jcfg = dataclasses.replace(jcfg, act_quant=mode == "w8a8")
        tcfg = dataclasses.replace(tcfg, act_quant=mode == "w8a8")
    ids = rng.integers(0, GPT2_NANO.vocab_size, 300)
    want = jev.perplexity(jp, jcfg, ids, window=window, batch_size=batch)
    got = ev.perplexity(tp, tcfg, ids, window=window, batch_size=batch)
    assert math.isclose(got, want, rel_tol=1e-5 if mode == "fp32" else QUANT_RTOL), (got, want)


def test_ppl_gate_demo_matches_jax_tool(monkeypatch, capsys):
    """``--demo --device cpu`` on the JAX tool's GPT2_MICRO weights (the
    port's demo draws its own from a torch seed; here its init returns the
    JAX package's), modes int8 and int4 (w8a8 is held to the JAX package's
    perplexity above): the same table shape, JSON line, rows and verdict,
    the perplexities within the tolerances above."""
    jparams = jgpt2.init_params(GPT2_MICRO, jax.random.PRNGKey(0), jnp.float32)
    monkeypatch.setattr(tgpt2, "init_params", lambda config, gen, dtype: params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    argv = ["--demo", "--batch", "8", "--modes", "int8,int4"]
    assert jtool.main(argv) == 0
    jout = capsys.readouterr().out.strip().splitlines()
    assert ttool.main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out.strip().splitlines()
    assert len(tout) == len(jout) == 5 and tout[0] == jout[0]
    want, got = json.loads(jout[-1]), json.loads(tout[-1])
    assert got["gate"] == want["gate"] == "ppl" and got["tokens"] == want["tokens"] == 4096
    assert got["pass"] is want["pass"] is True
    assert [r["mode"] for r in got["rows"]] == ["fp32", "int8", "int4"]
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["mode"], g["budget"], g["pass"]) == (w["mode"], w["budget"], w["pass"])
        tol = 1e-5 if g["mode"] == "fp32" else QUANT_RTOL
        assert math.isclose(g["ppl"], w["ppl"], rel_tol=tol), (g, w)
        assert abs(g["delta"] - w["delta"]) <= 2 * QUANT_RTOL * w["ppl"], (g, w)


def test_ppl_gate_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttool.main(["--demo"])
