"""``.npz`` parameter trees and the repacker in the port (CPU) against the
JAX package's: ``utils.io.save_pytree_npz`` / ``load_pytree_npz``,
``tools.repack`` and the CLI's ``--weights x.npz``.

Oracle: bytes. A file either package writes loads in the other leaf for
leaf with the same dtype, shape and bits, the meta included; the two
repackers write the same leaves from one raw checkpoint (both quantize in
f32, dividing, rounding half to even and clipping element for element).
A bfloat16 leaf, which ``np.savez`` stores as 2-byte void records, is
refused by both loaders. The CLI's greedy tokens on a repacked file equal
the JAX engine's on the same tree. Weights are GPT2_NANO's times 3, so
that greedy streams differ per prompt.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from zig_gpt2_tpu.config import GPT2_NANO, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu.tools import repack as jrepack
from zig_gpt2_tpu.utils import io as jio
from zig_gpt2_tpu_torch import cli as tcli
from zig_gpt2_tpu_torch.quant import quantize as tq
from zig_gpt2_tpu_torch.tokenizer import Encoder, train_bpe
from zig_gpt2_tpu_torch.tools import repack as trepack
from zig_gpt2_tpu_torch.utils import io as tio
from zig_gpt2_tpu_torch.weights import params_from_numpy

# tree name -> (quantize mode, group size, meta); w8a8 serves the
# per-channel INT8 tree with act_quant set in the config.
TREES = {"float": (None, None, None),
         "int8": ("int8", None, {"model": "nano", "mode": "int8"}),
         "int8-g64": ("int8", 64, {"model": "nano", "mode": "int8"}),
         "int4": ("int4", None, {"model": "nano", "mode": "int4"}),
         "w8a8": ("int8", None, {"model": "nano", "mode": "w8a8", "act_quant": True})}


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(lambda x: x * 3.0, jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(0)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _flat(tree, prefix=""):
    """{'/'-joined path: numpy leaf} of a tree of numpy, JAX or torch leaves."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _assert_same_leaves(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("tree", list(TREES))
def test_npz_interchange_bit_equal(params, tmp_path, tree):
    """JAX-written -> port-loaded and port-written -> JAX-loaded, every
    leaf and the meta; both quantizers give the same file."""
    mode, group, meta = TREES[tree]
    jp, tp = params
    if mode:
        jp = jq.quantize_params(jp, mode=mode, group_size=group)
        tp = tq.quantize_params(tp, mode=mode, group_size=group)
    jio.save_pytree_npz(jp, tmp_path / "jax.npz", meta=meta)
    got, got_meta = tio.load_pytree_npz(tmp_path / "jax.npz", device="cpu", with_meta=True)
    _assert_same_leaves(got, jp)
    assert got_meta == meta
    tio.save_pytree_npz(tp, tmp_path / "port.npz", meta=meta)
    back, back_meta = jio.load_pytree_npz(tmp_path / "port.npz", with_meta=True)
    _assert_same_leaves(back, jp)
    assert back_meta == meta
    assert tio.load_pytree_npz(tmp_path / "port.npz", device="cpu", with_meta=True)[1] == meta
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert a.files == b.files


@pytest.mark.parametrize("mode,group,lm_head", [("int8", 32, True), ("int4", 64, True),
                                                ("int8", None, False), ("int4", None, False)],
                         ids=["int8-g32", "int4-g64", "int8-no-lm-head", "int4-no-lm-head"])
def test_quantize_params_options_bit_equal_to_jax(params, mode, group, lm_head):
    """group_size (every linear, the lm_head included) and
    quantize_lm_head, as the JAX package's quantize_params takes them; and
    the tensor-parallel alignment (tp=2: the c_proj groups divide K/2)."""
    jp, tp = params
    want = jq.quantize_params(jp, mode=mode, group_size=group, quantize_lm_head=lm_head)
    got = tq.quantize_params(tp, mode=mode, group_size=group, quantize_lm_head=lm_head)
    _assert_same_leaves(got, want)
    assert ("lm_head" in got) == lm_head
    _assert_same_leaves(tq.quantize_params(tp, mode=mode, tp=2),
                        jq.quantize_params(jp, mode=mode, tp=2))


@pytest.mark.parametrize("mode,group", [("int8", None), ("int4", None), ("int4", 16)],
                         ids=["int8", "int4", "int4-g16"])
def test_repack_tools_write_identical_leaves(params, tmp_path, capsys, mode, group):
    jio.save_gpt2_raw(params[0], tmp_path / "raw", GPT2_NANO)
    flags = ["--raw", str(tmp_path / "raw"), "--model", "nano", "--mode", mode]
    if group:
        flags += ["--group-size", str(group)]
    jrepack.main(flags + ["--out", str(tmp_path / "jax.npz")])
    trepack.main(flags + ["--out", str(tmp_path / "port.npz")])
    assert "wrote" in capsys.readouterr().out
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
        assert json.loads(bytes(b["__zg2_meta__"])) == {"model": "nano", "mode": mode}
    jrepack.main(flags + ["--tp", "2", "--out", str(tmp_path / "jax_tp.npz")])
    trepack.main(flags + ["--tp", "2", "--out", str(tmp_path / "tp.npz")])
    with np.load(tmp_path / "jax_tp.npz") as a, np.load(tmp_path / "tp.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key


def test_bf16_leaf_refused_like_jax(tmp_path):
    """np.savez stores a bfloat16 leaf as |V2 records. The JAX loader
    refuses them (TypeError, when it puts leaves on the device); the port's
    loader refuses them too, naming the leaf, and the port writes a bf16
    tensor as the same records."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jio.save_pytree_npz({"a": {"w": jnp.asarray(w, jnp.bfloat16)}, "n": jnp.arange(3)},
                        tmp_path / "jax.npz")
    with pytest.raises(TypeError):
        jio.load_pytree_npz(tmp_path / "jax.npz")
    with pytest.raises(TypeError, match="'a/w'"):
        tio.load_pytree_npz(tmp_path / "jax.npz", device="cpu")
    tio.save_pytree_npz({"a": {"w": torch.from_numpy(w).bfloat16()}}, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert b["a/w"].dtype.kind == "V" and b["a/w"].tobytes() == a["a/w"].tobytes()
    with pytest.raises(TypeError):
        jio.load_pytree_npz(tmp_path / "port.npz")


def _corpus():
    rng = np.random.default_rng(0)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    return " ".join("".join(rng.choice(letters, int(rng.integers(2, 8)))) for _ in range(400))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_cli_serves_repacked_npz_like_jax_engine(params, tmp_path, capsys, mode):
    """The JAX repacker's file through the port's CLI (--weights x.npz):
    greedy text equal to the JAX engine's on the same tree."""
    vocab, _ = train_bpe(_corpus(), vocab_size=GPT2_NANO.vocab_size)
    assert len(vocab) == GPT2_NANO.vocab_size  # every id the model can emit decodes
    (tmp_path / "encoder.json").write_text(json.dumps(vocab))
    jio.save_gpt2_raw(params[0], tmp_path / "raw", GPT2_NANO)
    jrepack.main(["--raw", str(tmp_path / "raw"), "--model", "nano", "--mode", mode,
                  "--out", str(tmp_path / "w.npz")])
    capsys.readouterr()
    enc = Encoder.from_files(tmp_path / "encoder.json", None, mode="greedy")
    jtree = jio.load_pytree_npz(tmp_path / "w.npz")
    for prompt in ("the quick", "lazy dog over"):
        tcli.main(["--model", "nano", "--weights", str(tmp_path / "w.npz"), "--encoder-dir",
                   str(tmp_path), "--device", "cpu", "--temp", "0", "--max-tokens", "8", prompt])
        got = capsys.readouterr().out
        want = JEngine(GPT2_NANO, jtree, max_seq=64).generate(
            enc.encode(prompt), 8, JSampling(temperature=0.0))
        assert got == prompt + enc.decode(want) + "\n"
