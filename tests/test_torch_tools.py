"""The port's offline tools and debug hooks (CPU) against the JAX
package's: the PyTorch oracle, the golden-file writer, the weight
converters, ``utils.profiling`` and ``utils.debug``.

Oracle: bytes and bits. The port's copies of the oracle and of the
golden-file writer run the same PyTorch code as the JAX package's, so
their logits and files are identical; the converters write the same raw
files from one checkpoint (a HuggingFace model or a TF checkpoint built
here, small). The converted HuggingFace model, served by the port's
``forward``, gives HuggingFace's logits within ``assert_logits_close``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from zig_gpt2_tpu.config import GPT2_NANO
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.tools import download_weights as jdw
from zig_gpt2_tpu.tools import generate_test_data as jgen
from zig_gpt2_tpu.tools import oracle as joracle
from zig_gpt2_tpu_torch import cli as tcli
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.tools import download_weights as tdw
from zig_gpt2_tpu_torch.tools import generate_test_data as tgen
from zig_gpt2_tpu_torch.tools import oracle as toracle
from zig_gpt2_tpu_torch.utils import debug, profiling
from zig_gpt2_tpu_torch.utils import io as tio
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = tconfig.GPT2_NANO
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(0)))
    return jp, params_from_numpy(jp)


def _same_files(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return names


def test_oracle_copy_matches_jax_oracle(params, rng):
    np_params, tp = params
    toks = rng.integers(0, GPT2_NANO.vocab_size, (2, 11))
    got = toracle.forward(np_params, toks, TCFG)
    np.testing.assert_array_equal(got, joracle.forward(np_params, toks, GPT2_NANO))
    assert_logits_close(tgpt2.forward(tp, torch.from_numpy(toks), TCFG).numpy(), got)


def test_golden_files_byte_identical(tmp_path):
    shapes = tgen.write_golden_files(tmp_path / "port", seed=3)
    assert shapes == jgen.write_golden_files(tmp_path / "jax", seed=3)
    assert tgen.REFERENCE_FILE_SET == jgen.REFERENCE_FILE_SET <= set(shapes)
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "embedding_inputs").stat().st_size == 3 * 8  # raw int64


def test_hf_converter_and_byte_encoder_identical(tmp_path, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")  # transformers' torch side only
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.GPT2Config(vocab_size=100, n_positions=32, n_embd=64, n_layer=2,
                                     n_head=2)
    model = transformers.GPT2LMHeadModel(hf_cfg).eval()
    for out, mod in (("port", tdw), ("jax", jdw)):
        assert mod.convert_hf_model(model, tmp_path / out) == 4 + 12 * 2
        mod.write_byte_encoder(tmp_path / out)
    _same_files(tmp_path / "port" / "raw", tmp_path / "jax" / "raw")
    table = (tmp_path / "port" / "byte_encoder.json").read_bytes()
    assert table == (tmp_path / "jax" / "byte_encoder.json").read_bytes()
    assert len(json.loads(table)) == 256
    cfg = tconfig.GPTConfig(vocab_size=100, context_size=32, n_layers=2, n_heads=2, n_embed=64)
    tp = tio.load_gpt2_raw(tmp_path / "port" / "raw", cfg)
    toks = torch.tensor([[5, 17, 3, 99, 42, 7]])
    with torch.no_grad():
        want = model(toks).logits.numpy()
    assert_logits_close(tgpt2.forward(tp, toks, cfg).numpy(), want)


def test_tf_converter_identical(tmp_path):
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(0)
    shapes = {"model/wte": (20, 8), "model/wpe": (6, 8), "model/h0/ln_1/g": (8,),
              "model/h0/attn/c_attn/w": (1, 8, 24), "model/h0/attn/c_attn/b": (24,),
              "model/ln_f/b": (8,)}
    prefix = tmp_path / "ckpt" / "model.ckpt"
    with tf.Graph().as_default():
        for name, shape in shapes.items():
            tf.compat.v1.get_variable(name, initializer=rng.standard_normal(shape)
                                      .astype(np.float32))
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(prefix))
    assert tdw.convert_tf_checkpoint(prefix, tmp_path / "port") == len(shapes)
    assert jdw.convert_tf_checkpoint(prefix, tmp_path / "jax") == len(shapes)
    names = _same_files(tmp_path / "port" / "raw", tmp_path / "jax" / "raw")
    assert "model-h0-attn-c_attn-w" in names  # (1, in, out) -> (out, in)
    w = np.fromfile(tmp_path / "port" / "raw" / "model-h0-attn-c_attn-w", np.float32)
    assert w.size == 8 * 24


def test_download_needs_the_network_and_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="network"):
        tdw.main(["--download", "124M", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_device_timer_and_profiler_trace(params, tmp_path):
    _, tp = params
    toks = torch.tensor([[1, 2, 3, 4]])
    with profiling.device_timer() as t:
        t["out"] = tgpt2.forward(tp, toks, TCFG)
    assert t["ms"] > 0 and t["out"].shape == (1, 4, TCFG.vocab_size)
    with profiling.device_timer(block_on=[t["out"]]) as t2:
        pass
    assert t2["ms"] >= 0
    with profiling.profiler_trace(None):
        tgpt2.forward(tp, toks, TCFG)
    with profiling.profiler_trace(str(tmp_path / "trace"), device="cpu"):
        tgpt2.forward(tp, toks, TCFG)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    tcli.main(["--demo", "--device", "cpu", "--temp", "0", "--max-tokens", "3", "--profile",
               str(tmp_path / "cli"), "the quick"])
    assert (tmp_path / "cli" / "trace.json").stat().st_size > 0


def test_nan_checks_name_the_op(params):
    _, tp = params
    toks = torch.tensor([[1, 2, 3, 4]])
    with debug.nan_checks():  # clean weights: silent (the masks are finite)
        tgpt2.forward(tp, toks, TCFG)
    with debug.nan_checks(enable=False):
        pass
    bad = dict(tp, wte=tp["wte"].clone())
    bad["wte"][2, 5] = float("nan")
    with pytest.raises(FloatingPointError, match=r"aten\.index.*NaN"):
        with debug.nan_checks():
            tgpt2.forward(bad, toks, TCFG)
    ln = dict(tp, ln_f={"w": tp["ln_f"]["w"].clone(), "b": tp["ln_f"]["b"]})
    ln["ln_f"]["w"][0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"aten\.mul.*infinity"):
        with debug.nan_checks():
            tgpt2.forward(ln, toks, TCFG)
    tgpt2.forward(bad, toks, TCFG)  # outside the context nothing checks


def test_checked_decode_step(params):
    _, tp = params
    step = debug.checked_decode_step(TCFG)
    cache = tgpt2.init_kv_cache(TCFG, 2, 16)
    cache, _ = tgpt2.prefill(tp, cache, torch.tensor([[1, 2, 3], [4, 5, 0]]),
                             torch.tensor([3, 2]), TCFG)
    ref = {k: v.clone() for k, v in cache.items()}
    _, got = step(tp, cache, torch.tensor([7, 8]))
    _, want = tgpt2.decode_step(tp, ref, torch.tensor([7, 8]), TCFG)
    assert torch.equal(got, want)
    for bad in ([16, 3], [2, -1]):
        cache["length"] = torch.tensor(bad, dtype=torch.int32)
        with pytest.raises(ValueError, match="outside"):
            step(tp, cache, torch.tensor([7, 8]))


def test_no_tool_imports_a_converter_library_at_import():
    """tensorflow and transformers load only inside the converters: the
    card's machine has neither."""
    code = ("import sys; import zig_gpt2_tpu_torch.tools.download_weights, "
            "zig_gpt2_tpu_torch.tools.repack, zig_gpt2_tpu_torch.tools.ppl_gate; "
            "print(sorted(m for m in ('tensorflow', 'transformers', 'jax') if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True).stdout
    assert out.strip() == "[]"
