"""The host-side tensor-parallel layouts of the port against the JAX
package's, in one process (bytes as the oracle):

- ``sharding.padded_dims`` and ``pad_for_tp`` trees for tp 2, 4 and 8 on
  GPT2_NANO, GPT2_MICRO and a five-head config (heads and vocab padded);
  idempotent, and refusing an n_embed that does not divide or a quantized
  tree that needs padding;
- ``quantize_params(tp=)`` grouped INT8 and INT4 trees, group sizes
  included (``pick_group_size(k, mode, tp)`` over a grid);
- the placement table (``parallel.mesh.step_param_rules``, ``cache_rules``)
  cuts every rank's slice exactly as the JAX package's NamedShardings
  (``step_spmd.step_param_pspecs``, ``mesh.cache_pspecs``) place it on the
  device of the same (data, model) coordinate, float, INT8 and INT4
  trees, float and ring INT8 caches, meshes 1x2, 2x2 and 2x4;
- ``tools.repack --tp`` files byte-equal between the packages and loadable
  both ways;
- the port's CLI serves a JAX ``repack --tp 8`` tree (four zero heads of
  padding) with the JAX CLI's greedy text, on one device and over
  ``--mesh 1x2`` (two spawned CPU ranks, gloo).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import port_config
from zig_gpt2_tpu import cli as jcli
from zig_gpt2_tpu.config import GPT2_MICRO, GPT2_NANO, GPTConfig
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.parallel import mesh as jmesh
from zig_gpt2_tpu.parallel import sharding as jsh
from zig_gpt2_tpu.parallel import step_spmd as jstep
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu.tools import repack as jrepack
from zig_gpt2_tpu.utils import io as jio
from zig_gpt2_tpu_torch import cli as tcli
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.parallel import mesh as tmesh
from zig_gpt2_tpu_torch.parallel import sharding as tsh
from zig_gpt2_tpu_torch.parallel.distributed import Collectives
from zig_gpt2_tpu_torch.quant import quantize as tq
from zig_gpt2_tpu_torch.tokenizer import train_bpe
from zig_gpt2_tpu_torch.tools import repack as trepack
from zig_gpt2_tpu_torch.utils import io as tio
from zig_gpt2_tpu_torch.weights import params_from_numpy

FIVE = GPTConfig(vocab_size=1000, context_size=16, n_layers=2, n_heads=5, n_embed=320)
CFGS = {"nano": GPT2_NANO, "micro": GPT2_MICRO, "five-heads": FIVE}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _assert_same_leaves(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, cfg in CFGS.items():
        jp = jax.tree.map(lambda a: a * 3.0, jgpt2.init_params(cfg, jax.random.PRNGKey(1)))
        out[name] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp)))
    return out


def _tcfg(cfg):
    return tconfig.GPTConfig(**port_config(cfg))


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("name", list(CFGS))
def test_pad_for_tp_bit_equal_to_jax(trees, name, tp):
    cfg = CFGS[name]
    assert tsh.padded_dims(_tcfg(cfg), tp) == jsh.padded_dims(cfg, tp)
    jp, tp_tree = trees[name]
    jpad, jcfg = jsh.pad_for_tp(jp, cfg, tp)
    tpad, tcfg = tsh.pad_for_tp(tp_tree, _tcfg(cfg), tp)
    _assert_same_leaves(tpad, jpad)
    assert (tcfg.padded_heads, tcfg.padded_vocab_size) == (jcfg.padded_heads,
                                                           jcfg.padded_vocab_size)
    again, cfg2 = tsh.pad_for_tp(tpad, tcfg, tp)  # idempotent
    assert again is tpad and cfg2 == tcfg


def test_pad_for_tp_refusals(trees):
    jp, tp_tree = trees["five-heads"]
    with pytest.raises(ValueError, match="n_embed 320 not divisible by tp=3"):
        tsh.pad_for_tp(tp_tree, _tcfg(FIVE), 3)
    with pytest.raises(ValueError, match="requantize from float weights after padding"):
        tsh.pad_for_tp(tq.quantize_params(tp_tree, "int8"), _tcfg(FIVE), 2)
    # A quantized tree whose dims already divide passes unchanged.
    q = tq.quantize_params(tp_tree, "int8")
    five_even = dataclasses.replace(_tcfg(FIVE), padded_heads=6, padded_vocab_size=1024)
    assert tsh.pad_for_tp(q, five_even, 2)[0] is q


@pytest.mark.parametrize("k", [64, 128, 256, 768, 1024, 1600, 3072, 6400])
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_pick_group_size_equals_jax(k, mode, tp):
    try:
        want = jq.pick_group_size(k, mode, tp)
    except ValueError:
        with pytest.raises(ValueError):
            tq.pick_group_size(k, mode, tp)
        return
    assert tq.pick_group_size(k, mode, tp) == want


@pytest.mark.parametrize("name,tp,mode,group", [
    ("nano", 4, "int4", None), ("micro", 2, "int4", None), ("five-heads", 2, "int8", 16),
    ("five-heads", 2, "int4", None), ("five-heads", 4, "int4", None)])
def test_quantize_params_tp_bit_equal_to_jax(trees, name, tp, mode, group):
    """The grouped layouts, whose groups tp constrains (per-channel INT8
    ignores tp; ``tests/test_torch_npz.py`` holds it at tp=2 too)."""
    cfg = CFGS[name]
    jp, tp_tree = trees[name]
    jpad, _ = jsh.pad_for_tp(jp, cfg, tp)
    tpad, _ = tsh.pad_for_tp(tp_tree, _tcfg(cfg), tp)
    want = jq.quantize_params(jpad, mode=mode, group_size=group, tp=tp)
    got = tq.quantize_params(tpad, mode=mode, group_size=group, tp=tp)
    _assert_same_leaves(got, want)


def _fake_mesh(dp, tp, d, m):
    """Mesh coordinate (d, m) without a process group: the placement table
    reads only the coordinate."""
    ranks = range(dp * tp)
    return tmesh.Mesh(dp, tp, d * tp + m, torch.device("cpu"),
                      Collectives(ranks[d * tp:(d + 1) * tp], m, "cpu"),
                      Collectives(ranks[m::tp], d, "cpu"))


def _device_shards(jarr):
    return {s.device: np.asarray(s.data) for s in jarr.addressable_shards}


def _assert_placement(tree_np, jax_specs, rules, dp, tp):
    mesh = jmesh.make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
    flat_specs = _flat_specs(jax_specs)
    flat_np = _flat(tree_np)
    for d in range(dp):
        for m in range(tp):
            got = _flat(tmesh.shard(params_from_numpy(tree_np), rules, _fake_mesh(dp, tp, d, m)))
            for key, leaf in flat_np.items():
                from jax.sharding import NamedSharding

                jarr = jax.device_put(leaf, NamedSharding(mesh, flat_specs[key]))
                want = _device_shards(jarr)[mesh.devices[d, m]]
                assert got[key].shape == want.shape, (key, d, m)
                assert got[key].tobytes() == want.tobytes(), (key, d, m)


def _flat_specs(specs, prefix=""):
    out = {}
    for k, v in specs.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat_specs(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_param_placement_equals_jax_named_shardings(trees, mode, dp, tp):
    """Float (wte split by vocab, tied lm_head), INT8 per-channel (the row
    scale replicated) and INT4 grouped (the row scales replicated: the
    step-level exception), each leaf on each coordinate."""
    cfg = CFGS["five-heads"]
    jp, _ = trees["five-heads"]
    jpad, jcfg = jsh.pad_for_tp(jp, cfg, tp)
    if mode is not None:
        jpad = jq.quantize_params(jpad, mode=mode, tp=tp)
    jcfg = dataclasses.replace(jcfg, mesh=jmesh.make_mesh(dp, tp,
                                                          devices=jax.devices()[:dp * tp]))
    tree_np = jax.tree.map(np.asarray, jpad)
    specs = jstep.step_param_pspecs(jcfg, jpad)
    _assert_placement(tree_np, specs, tmesh.step_param_rules(params_from_numpy(tree_np)), dp, tp)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("quant,ring", [(None, False), ("int8", True)])
def test_cache_placement_equals_jax_named_shardings(quant, ring, dp, tp):
    cfg = dataclasses.replace(GPT2_NANO, ring_cache=ring)
    cache = jgpt2.init_kv_cache(cfg, 4, 16, quant=quant)
    cache = {k: (jax.random.normal(jax.random.PRNGKey(i), v.shape).astype(v.dtype)
                 if v.dtype != jnp.int8 and v.ndim > 1 else v)
             for i, (k, v) in enumerate(cache.items())}
    cache = jax.tree.map(np.asarray, cache)
    cache["length"] = np.arange(4, dtype=np.int32)
    if ring:
        cache["start"] = np.arange(4, dtype=np.int32) + 7
        cache["wptr"] = np.asarray(3, np.int32)
    cache["k"] = np.random.default_rng(0).integers(-127, 127, cache["k"].shape).astype(
        cache["k"].dtype)
    specs = jmesh.cache_pspecs(cfg, quant=quant, data_sharded=True, ring=ring)
    _assert_placement(cache, specs, tmesh.cache_rules(cache), dp, tp)


def _raw(tmp_path, trees):
    jio.save_gpt2_raw(trees["nano"][0], tmp_path / "raw", GPT2_NANO)
    return str(tmp_path / "raw")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_repack_tp_files_byte_equal_both_ways(trees, tmp_path, capsys, mode):
    """``--tp 8``: four zero heads padded in (vocab 512 already divides).
    The two tools write the same leaves and meta; each package loads the
    other's file and writes it back byte for byte."""
    flags = ["--raw", _raw(tmp_path, trees), "--model", "nano", "--mode", mode, "--tp", "8"]
    jrepack.main(flags + ["--out", str(tmp_path / "jax.npz")])
    trepack.main(flags + ["--out", str(tmp_path / "port.npz")])
    assert "tp=8" in capsys.readouterr().out
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
        assert json.loads(bytes(b["__zg2_meta__"])) == {
            "model": "nano", "mode": mode, "tp": 8, "padded_heads": 8, "padded_vocab_size": None}
    tree, meta = tio.load_pytree_npz(tmp_path / "jax.npz", device="cpu", with_meta=True)
    tio.save_pytree_npz(tree, tmp_path / "back.npz", meta=meta)
    jtree, jmeta = jio.load_pytree_npz(tmp_path / "port.npz", with_meta=True)
    jio.save_pytree_npz(jtree, tmp_path / "jback.npz", meta=jmeta)
    for name in ("back.npz", "jback.npz"):
        with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / name) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(a[k].tobytes() == b[k].tobytes() for k in a.files), name


def test_cli_serves_jax_repack_tp_tree_like_the_jax_cli(trees, tmp_path, capfd):
    """The JAX ``repack --tp 8 --mode int4`` file through both CLIs,
    greedy, 8 tokens: the port's text equals the JAX CLI's on one device
    and over ``--mesh 1x2`` (ranks spawned by the CLI itself)."""
    rng = np.random.default_rng(0)
    words = ("".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), int(rng.integers(2, 8))))
             for _ in range(400))
    vocab, _ = train_bpe(" ".join(words), vocab_size=GPT2_NANO.vocab_size)
    (tmp_path / "encoder.json").write_text(json.dumps(vocab))
    jrepack.main(["--raw", _raw(tmp_path, trees), "--model", "nano", "--mode", "int4",
                  "--tp", "8", "--out", str(tmp_path / "w.npz")])
    common = ["--model", "nano", "--weights", str(tmp_path / "w.npz"), "--encoder-dir",
              str(tmp_path), "--temp", "0", "--max-tokens", "8", "--kv-quant"]
    capfd.readouterr()
    for prompt in ("the quick", "lazy dog over"):
        jcli.main(common + [prompt])
        want = capfd.readouterr().out
        assert want.startswith(prompt) and len(want) > len(prompt) + 2
        tcli.main(common + ["--device", "cpu", prompt])
        assert capfd.readouterr().out == want
    tcli.main(common + ["--device", "cpu", "--mesh", "1x2", "lazy dog over"])
    assert capfd.readouterr().out == want


def test_local_config_and_padded_heads_under_a_mesh(trees):
    """The per-rank config: heads / tp, the model group set; the five-head
    tree padded for tp=2 serves 3 heads per rank, odd, so unpacked."""
    _, tp_tree = trees["five-heads"]
    params, cfg = tsh.pad_for_tp(tp_tree, _tcfg(FIVE), 2)
    mesh = _fake_mesh(1, 2, 0, 1)
    local = tmesh.local_config(cfg, mesh)
    assert local.attn_heads == 3 and local.model_group is mesh.model
    assert not tgpt2.default_kv_packed(cfg, "cuda", tp=2)
    with pytest.raises(ValueError, match="pad the tree first"):
        tmesh.local_config(_tcfg(FIVE), mesh)
    with pytest.raises(ValueError, match="not divisible by data-parallel degree 2"):
        tmesh.prepare_serving(params, cfg, _fake_mesh(2, 1, 0, 0), 3, "cpu")
