"""The port's engine, tokenizer, raw checkpoint IO and CLI (CPU), against
the JAX package where it has a counterpart, and the rule that the port
imports nothing of JAX or the JAX package."""

import io
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.tolerance import assert_tensors_close
from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jquant
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu.tokenizer import Encoder as JEncoder
from zig_gpt2_tpu.tokenizer import train_bpe as jtrain_bpe
from zig_gpt2_tpu.utils import io as jio
from zig_gpt2_tpu_torch import cli as tcli
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.quant import quantize as tquant
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine, StreamDecoder
from zig_gpt2_tpu_torch.tokenizer import Encoder, train_bpe
from zig_gpt2_tpu_torch.utils import io as tio
from zig_gpt2_tpu_torch.weights import params_from_numpy, params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
TCFG = tconfig.GPT2_NANO

CORPUS = (
    "Héllo wörld! Ça va? naïve café, Straße. I'm here, they're there; we've it. "
    "東京タワーは高い。 北京欢迎你 한국어 텍스트 😀🎉👍🏽 emoji runs 😀😀 "
    "numbers 12345 x² ½ Ⅻ ③ ٣ 4.5e-3 and   runs    of  spaces\t\ttabs\n\nnewlines  "
    "trailing   ")


@pytest.fixture(scope="module")
def nano_params():
    jp = jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(7))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def engines(nano_params):
    jp, tp = nano_params
    return (JEngine(GPT2_NANO, jp, max_seq=32, prompt_buckets=(8,)),
            InferenceEngine(TCFG, tp, max_seq=32, prompt_buckets=(8,), device="cpu"))


@pytest.mark.parametrize("prompt", [[1, 2, 3, 4], [100, 7], [5] * 8])
def test_greedy_tokens_identical_to_jax(engines, prompt):
    jeng, teng = engines
    want = jeng.generate(prompt, 12, JSampling(temperature=0.0))
    got = teng.generate(prompt, 12, SamplingConfig(temperature=0.0))
    assert got == want


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantized_greedy_tokens_identical_to_jax(monkeypatch, nano_params, mode):
    """INT4 or INT8 weights with an INT8 KV cache. The JAX engine runs the
    deferred Pallas kernel in interpret mode (ZG2_FUSED_ATTN=interpret),
    whose all-f32 INT8 attention the port follows; nano's head_dim of 32
    keeps the JAX engine on the unpacked layout."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    jp, tp = nano_params
    jeng = JEngine(GPT2_NANO, jquant.quantize_params(jp, mode), max_seq=32,
                   prompt_buckets=(8,), kv_quant="int8")
    assert not jeng.config.kv_packed
    teng = InferenceEngine(TCFG, tquant.quantize_params(tp, mode), max_seq=32,
                           prompt_buckets=(8,), device="cpu", kv_quant="int8")
    assert teng.new_cache()["k"].dtype == torch.int8
    for prompt in ([1, 2, 3, 4], [100, 7]):
        want = jeng.generate(prompt, 12, JSampling(temperature=0.0))
        assert teng.generate(prompt, 12, SamplingConfig(temperature=0.0)) == want


def test_context_budget_and_stop(engines):
    _, teng = engines
    out = teng.generate([1] * 5, None, SamplingConfig(temperature=0.0))
    assert len(out) == 32 - 5
    full = teng.generate([1, 2, 3], 12, SamplingConfig(temperature=0.0))
    stop = full[4]
    out = teng.generate([1, 2, 3], 12, SamplingConfig(temperature=0.0), stop_tokens=[stop])
    assert out == full[:full.index(stop)]


def test_seeded_sampling_reproducible_and_chunk_invariant(nano_params):
    _, tp = nano_params
    s = SamplingConfig(temperature=0.8, top_k=40, top_p=0.95, seed=123)
    one = InferenceEngine(TCFG, tp, max_seq=32, prompt_buckets=(8,), device="cpu")
    four = InferenceEngine(TCFG, tp, max_seq=32, prompt_buckets=(8,), device="cpu",
                           decode_chunk=4)
    a = one.generate([5, 6, 7], 10, s)
    assert a == one.generate([5, 6, 7], 10, s) == four.generate([5, 6, 7], 10, s)
    assert a != one.generate([5, 6, 7], 10, SamplingConfig(temperature=0.8, seed=124))


def test_generate_scan_matches_streaming(engines):
    _, teng = engines
    scan = InferenceEngine(TCFG, teng.params, batch_size=2, max_seq=32,
                           prompt_buckets=(8,), device="cpu")
    prompts = np.zeros((2, 8), np.int32)
    prompts[0, :3] = [1, 2, 3]
    prompts[1, :5] = [9, 8, 7, 6, 5]
    got = scan.generate_scan(prompts, [3, 5], 6, SamplingConfig(temperature=0.0))
    for b, n in enumerate([3, 5]):
        stream = teng.generate(list(prompts[b, :n]), 7, SamplingConfig(temperature=0.0))
        assert list(got[b]) == stream[1:]


def test_engine_refuses_unported_options(nano_params):
    _, tp = nano_params
    with pytest.raises(ValueError, match="KV quantization"):
        InferenceEngine(TCFG, tp, kv_quant="int4", device="cpu")
    with pytest.raises(TypeError):
        InferenceEngine(TCFG, tp, mesh="1x2", device="cpu")
    with pytest.raises(ValueError, match="single-sequence"):
        InferenceEngine(TCFG, tp, batch_size=2, device="cpu").register_prefix([1, 2])


def test_cuda_default_raises_without_card(nano_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(TCFG, nano_params[1])


def test_encoder_ids_match_jax():
    vocab, merges = jtrain_bpe(CORPUS * 2, vocab_size=400)
    assert train_bpe(CORPUS * 2, vocab_size=400) == (vocab, merges)
    ours, ref = Encoder(vocab, merges), JEncoder(vocab, merges)
    for text in (CORPUS, "x²+½=Ⅻ", "  \n  a  b\t\t\tc   ", "🏽🏽 ok", "ünïcödé 名前"):
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == text
    greedy, ref_greedy = Encoder(vocab, mode="greedy"), JEncoder(vocab, mode="greedy")
    assert greedy.encode(CORPUS) == ref_greedy.encode(CORPUS)


def test_stream_decoder_utf8_safe():
    vocab, merges = train_bpe("plain ascii text only", vocab_size=260)
    enc = Encoder(vocab, merges)
    text = "a€b😀c東"
    ids = [vocab[enc.byte_to_unicode[b]] for b in text.encode("utf-8")]  # one per byte
    dec = StreamDecoder(enc)
    pieces = [dec.push(i) for i in ids]
    assert "".join(pieces) + dec.flush() == text
    for p in pieces:
        p.encode("utf-8")  # never a lone surrogate or partial character
    assert pieces[1:4] == ["", "", "€"]
    dec.push(ids[3])  # a dangling lead byte is replaced at flush
    assert dec.flush() == "�"


def test_raw_roundtrip_against_jax(tmp_path, nano_params):
    jp, tp = nano_params
    jio.save_gpt2_raw(jp, tmp_path / "from_jax", GPT2_NANO)
    loaded = params_to_numpy(tio.load_gpt2_raw(tmp_path / "from_jax", TCFG))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = loaded
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    tio.save_gpt2_raw(tp, tmp_path / "from_torch", TCFG)
    names = sorted(p.name for p in (tmp_path / "from_jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "from_torch").iterdir())
    for n in names:
        assert (tmp_path / "from_jax" / n).read_bytes() == (tmp_path / "from_torch" / n).read_bytes()
    back = jio.load_gpt2_raw(tmp_path / "from_torch", GPT2_NANO, device_put=False)
    assert_tensors_close(back["blocks"]["attn"]["wv"]["w"], np.asarray(jp["blocks"]["attn"]["wv"]["w"]))
    bf16 = tio.load_gpt2_raw(tmp_path / "from_jax", TCFG, dtype=torch.bfloat16)
    assert bf16["wte"].dtype == torch.bfloat16


def test_cli_demo_cpu(capsys):
    tcli.main(["--demo", "--device", "cpu", "--max-tokens", "6", "--seed", "1",
               "--metrics", "the quick"])
    out, err = capsys.readouterr()
    assert out.startswith("the quick")
    assert '"generated_tokens": 6' in err and '"device": "cpu"' in err


@pytest.mark.parametrize("flag", [["--demo", "--mesh", "1x2", "--seq-parallel"],
                                  ["--weights", "w.npz"],
                                  ["--weights", "raw", "--draft-model", "nano",
                                   "--draft-weights", "d.npz"]],
                         ids=["mesh", "npz-weights", "npz-draft-weights"])
def test_cli_refuses_later_slices(flag, tmp_path, nano_params, capfd):
    """Options the port once refused are served. Sequence-parallel
    prefill under --mesh (two ranks spawned by the CLI itself) prints the
    one-device engine's greedy text. .npz checkpoints (the target's or the
    draft's), refused until the port could read them:
    greedy tokens from the .npz tree equal those from the same weights as
    a raw checkpoint. A nano model saved both ways, with an encoder.json
    that decodes every id it can emit."""
    rng = np.random.default_rng(0)
    words = ("".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), int(rng.integers(2, 8))))
             for _ in range(400))
    vocab, _ = train_bpe(" ".join(words), vocab_size=TCFG.vocab_size)
    (tmp_path / "encoder.json").write_text(json.dumps(vocab))
    tio.save_gpt2_raw(nano_params[1], tmp_path / "raw", TCFG)
    for name in ("w.npz", "d.npz"):
        tio.save_pytree_npz(nano_params[1], tmp_path / name)
    flag = [str(tmp_path / f) if f in ("raw", "w.npz", "d.npz") else f for f in flag]
    argv = ["--model", "nano", "--encoder-dir", str(tmp_path), "--device", "cpu", *flag]
    served = []
    if "--mesh" in flag:
        other = [f for f in argv if f not in ("--mesh", "1x2", "--seq-parallel")]
    else:
        other = [str(tmp_path / "raw") if f.endswith(".npz") else f for f in argv]
    capfd.readouterr()
    for args in (argv, other):
        tcli.main([*args, "--dtype", "fp32", "--temp", "0", "--max-tokens", "5", "ab cd"])
        served.append(capfd.readouterr().out)
    assert served[0].startswith("ab cd") and served[0] == served[1]


def test_cli_demo_quantized_cpu(capsys):
    """--quant int4 --kv-quant: INT4 weights, INT8 lm_head and KV cache."""
    tcli.main(["--demo", "--device", "cpu", "--quant", "int4", "--kv-quant",
               "--max-tokens", "6", "--temp", "0", "--metrics", "the quick"])
    out, err = capsys.readouterr()
    assert out.startswith("the quick")
    assert '"generated_tokens": 6' in err


def test_port_imports_no_jax():
    """Neither the port's package nor chip_smoke.py imports JAX or the JAX
    package."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|zig_gpt2_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "zig_gpt2_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = [m.group(0).strip() for m in bad.finditer(f.read_text())]
        assert not hits, f"{f.relative_to(ROOT)}: {hits}"
