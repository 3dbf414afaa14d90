"""The port's head-pair-packed KV cache (CPU) against the JAX package's.

Packed layout: two adjacent heads per cache row, (L, B, Hp, S, 2D) at
head_dim 64, a zero phantom head when H is odd, and for an INT8 cache one
f32 scale per head pair and token, planes (L, B, Hp, S). The JAX side runs
its Pallas packed kernel in interpret mode (``ZG2_FUSED_ATTN=interpret``),
under which its own ``default_kv_packed`` picks the packed layout for these
configs; the port runs its kernels' plain versions, and its runtimes take
the layout with ``ZG2_KV_PACKED=1``.

Tolerances: attention, f32 atol/rtol 1e-5 (the same f32 online softmax in
another order) and bf16 two bf16 ulps (rtol 1.6e-2, atol 1e-2), as in
``tests/test_torch_ring.py``; both are inside
``tests/test_attention_packed.py``'s tolerances of the JAX kernel against
its references. Model logits: ``assert_logits_close``. INT8 cache rows:
equal; their scales: ``assert_logits_close``. Layout helpers: bit for bit.
Engine and batcher: identical greedy tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tolerance import assert_logits_close
from zig_gpt2_tpu.config import GPTConfig, SamplingConfig as JSampling
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.ops import attention as jatt
from zig_gpt2_tpu.ops import layers as jops
from zig_gpt2_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from zig_gpt2_tpu.runtime.engine import InferenceEngine as JEngine
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.ops import attention as tatt
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine
from zig_gpt2_tpu_torch.weights import params_from_numpy, params_to_numpy

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1.6e-2, atol=1e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

CFG_EVEN = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=2, n_embed=128)
CFG_ODD = GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=3, n_embed=192)
CFGS = {"even": CFG_EVEN, "odd": CFG_ODD}
GREEDY = SamplingConfig(temperature=0.0)


def _tcfg(cfg):
    return tconfig.GPTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(tconfig.GPTConfig)})


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


# --- layout helpers -----------------------------------------------------------

@pytest.mark.parametrize("name,shape", [
    ("pack_heads_rows", (3, 6, 64)), ("unpack_heads_rows", (3, 3, 128)),
    ("pack_heads_seq", (2, 4, 5, 64)), ("unpack_heads_seq", (2, 2, 5, 128)),
    ("unpack_pair_scales_seq", (2, 3, 7)), ("unpack_pair_scales_rows", (2, 3))])
def test_layout_helpers_match_jax(rng, name, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(jatt, name)(jnp.asarray(x)))
    got = getattr(tatt, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- packed attention against the Pallas packed kernel -------------------------

L, B, HP, S, LAYER = 2, 3, 2, 21, 1


def _lanes(deferred):
    """(start, length) over B=3 lanes: starts 0, mid and S-1 against three
    lengths in each rotation (the deferred form takes 0; the appended form
    at least one row). The intervals from mid and S-1 wrap."""
    starts = np.array([0, S // 2, S - 1], np.int32)
    lengths = [0, 1, S - 1] if deferred else [1, 5, S]
    return [(starts, np.array(lengths[r:] + lengths[:r], np.int32)) for r in range(3)]


def _inputs(rng, quant, deferred):
    """Packed operands in the wrappers' order after q: the self-term rows
    (deferred) and the caches, with per-pair scales for INT8."""
    q = rng.standard_normal((B, HP, 128)).astype(np.float32)
    if not quant:
        new = [rng.standard_normal((B, HP, 128)).astype(np.float32) for _ in range(2)]
        caches = [rng.standard_normal((L, B, HP, S, 128)).astype(np.float32) for _ in range(2)]
        return q, new if deferred else [], caches
    new = []
    for _ in range(2):
        rows, scales = jops.quantize_kv(jnp.asarray(rng.standard_normal((B, HP, 128)),
                                                    jnp.float32))
        new += [np.array(rows), np.array(scales)]
    caches = []
    for _ in range(2):
        caches += [rng.integers(-127, 128, (L, B, HP, S, 128)).astype(np.int8),
                   (rng.random((L, B, HP, S)) * 0.02 + 1e-3).astype(np.float32)]
    return q, new if deferred else [], caches


JAX_KERNELS = {(False, True): jatt.decode_attention_deferred_fused,
               (True, True): jatt.decode_attention_quant_deferred_fused,
               (False, False): jatt.decode_attention_fused,
               (True, False): jatt.decode_attention_quant_fused}
PORT_KERNELS = {(False, True): tatt.decode_attention_deferred,
                (True, True): tatt.decode_attention_quant_deferred,
                (False, False): tatt.decode_attention,
                (True, False): tatt.decode_attention_quant}


@pytest.mark.parametrize("ring", [False, True], ids=["prefix", "ring"])
@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "appended"])
@pytest.mark.parametrize("quant,dtype", [(False, "f32"), (False, "bf16"), (True, "f32")],
                         ids=["float-f32", "float-bf16", "int8-f32q"])
def test_packed_attention_matches_pallas_kernel(rng, quant, dtype, deferred, ring):
    q, new, caches = _inputs(rng, quant, deferred)
    jargs = [jnp.asarray(q).astype(JDT[dtype])]
    targs = [torch.from_numpy(q).to(TDT[dtype])]
    for a in new + caches:
        jargs.append(jnp.asarray(a) if quant else jnp.asarray(a).astype(JDT[dtype]))
        targs.append(torch.from_numpy(a) if quant else torch.from_numpy(a).to(TDT[dtype]))
    jfn, tfn = JAX_KERNELS[quant, deferred], PORT_KERNELS[quant, deferred]
    for start, length in _lanes(deferred):
        kw = dict(start=torch.from_numpy(start)) if ring else {}
        want = jfn(*jargs, jnp.asarray(length), layer=jnp.int32(LAYER), interpret=True,
                   packed=True, start=jnp.asarray(start) if ring else None)
        got = tfn(*targs, torch.from_numpy(length), layer=LAYER, packed=True, **kw)
        assert got.dtype == TDT[dtype] and got.shape == (B, HP, 128)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype],
                                   err_msg=f"start={start} length={length}")
        if not quant:  # the same rows through the unpacked layout
            unpacked = [tatt.unpack_heads_rows(t) if t.dim() == 3 else
                        tatt.unpack_heads_seq(t) for t in targs]
            ref = tfn(*unpacked, torch.from_numpy(length), layer=LAYER, **kw)
            np.testing.assert_allclose(_f32(tatt.unpack_heads_rows(got)), _f32(ref),
                                       **TOL[dtype])


# --- the packed model against the JAX packed model ----------------------------

def _params(cfg):
    jp = jax.tree.map(lambda x: x * 3.0, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _ring_cache(rng, cfg, kv_quant, R):
    """A packed ring cache of 2 lanes with random rows, intervals [3, 8) and
    [6, 8) ending at the write row R - 2: six steps cross the wrap."""
    jc = jax.tree.map(np.asarray, jgpt2.init_kv_cache(cfg, 2, R, quant=kv_quant))
    for name in ("k", "v"):
        if kv_quant:
            jc[name] = rng.integers(-127, 128, jc[name].shape).astype(np.int8)
            jc[name + "_scale"] = (rng.random(jc[name + "_scale"].shape) * 0.05
                                   + 1e-3).astype(np.float32)
        else:
            jc[name] = rng.standard_normal(jc[name].shape).astype(np.float32)
    jc["start"] = np.array([3, R - 4], np.int32)
    jc["length"] = np.array([R - 5, 2], np.int32)
    jc["wptr"] = np.array(R - 2, np.int32)
    return jc


def _compare_caches(got, want, rows_of, kv_quant):
    for b in range(2):
        rows = rows_of(b)
        for name in (("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v")):
            g, w = got[name][:, b][:, :, rows], want[name][:, b][:, :, rows]
            if g.dtype == np.int8:
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                assert_logits_close(g, w, msg=name)


@pytest.mark.parametrize("kv_quant,ring,cfg", [
    (None, False, "odd"), (None, True, "even"), ("int8", False, "even"),
    ("int8", True, "odd")], ids=["float-linear-odd", "float-ring-even",
                                 "int8-linear-even", "int8-ring-odd"])
def test_packed_model_matches_jax(monkeypatch, rng, kv_quant, ring, cfg):
    """Linear: prefill of two prompts (5 and 8 tokens) plus 6 decode steps.
    Ring: 6 decode steps over a random packed ring cache, across the wrap.
    Logits match at every step; the rows written (inside each lane's
    interval) match, INT8 rows exactly. The four cases cover every pair of
    cache type, cache kind and head-count parity (each JAX configuration
    compiles for about 10 s)."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    cfg = dataclasses.replace(CFGS[cfg], kv_packed=True, ring_cache=ring)
    jp, tp = _params(cfg)
    tp, tcfg = tgpt2.pad_phantom_head(tp, _tcfg(cfg))
    if ring:
        R = 10
        jc = _ring_cache(rng, cfg, kv_quant, R)
        tc = params_from_numpy(jc)
        jc = jax.tree.map(jnp.asarray, jc)
    else:
        R = 16
        jc = jgpt2.init_kv_cache(cfg, 2, R, quant=kv_quant)
        tc = tgpt2.init_kv_cache(tcfg, 2, R, quant=kv_quant)
        toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        lengths = np.array([5, 8], np.int32)
        jc, jl = jgpt2.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), cfg)
        tc, tl = tgpt2.prefill(tp, tc, torch.from_numpy(toks), torch.from_numpy(lengths),
                               tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg="prefill")
    hp = (cfg.n_heads + 1) // 2
    assert tuple(tc["k"].shape) == (2, 2, hp, R, 128)
    if kv_quant:
        assert tuple(tc["k_scale"].shape) == (2, 2, hp, R)
    for step in range(6):
        toks = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        jc, jl = jgpt2.decode_step(jp, jc, jnp.asarray(toks), cfg)
        tc, tl = tgpt2.decode_step(tp, tc, torch.from_numpy(toks), tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg=f"step {step}")
    got, want = params_to_numpy(tc), jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(got["length"], want["length"])
    if ring:
        assert int(got["wptr"]) == int(want["wptr"]) == (R - 2 + 6) % R  # wrapped
        _compare_caches(got, want, lambda b: (want["start"][b] + np.arange(
            want["length"][b])) % R, kv_quant)
    else:
        _compare_caches(got, want, lambda b: np.arange(want["length"][b]), kv_quant)


def test_bridged_jax_cache_continues_identically(monkeypatch, rng):
    """A JAX packed INT8 cache (odd heads: a phantom head) crosses the
    bridge with its shapes and dtypes, and port decode steps continue it as
    the JAX model's do."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    cfg = dataclasses.replace(CFG_ODD, kv_packed=True)
    jp, tp = _params(cfg)
    tp, tcfg = tgpt2.pad_phantom_head(tp, _tcfg(cfg))
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jc, _ = jgpt2.prefill(jp, jgpt2.init_kv_cache(cfg, 2, 16, quant="int8"),
                          jnp.asarray(toks), jnp.asarray([6, 8], jnp.int32), cfg)
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), dtype=torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jax.tree.map(np.asarray, jc).items()}
    assert tuple(tc["k_scale"].shape) == (2, 2, 2, 16)  # per pair
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
        jc, jl = jgpt2.decode_step(jp, jc, jnp.asarray(tok), cfg)
        tc, tl = tgpt2.decode_step(tp, tc, torch.from_numpy(tok), tcfg)
        assert_logits_close(tl.numpy(), np.asarray(jl), msg=f"step {step}")
    _compare_caches(params_to_numpy(tc), jax.tree.map(np.asarray, jc),
                    lambda b: np.arange([9, 11][b]), "int8")


# --- the phantom head in the weights ----------------------------------------------

@pytest.mark.parametrize("weights", ["float", "int8", "int4"])
def test_phantom_head_in_the_weights_keeps_the_logits(weights):
    """``pad_phantom_head`` on 3 heads: a fourth head of exactly zero Q/K/V
    weights and c_proj rows (float, INT8 per-channel, INT4 grouped and
    repacked), and the same forward logits as the unpadded model (f32
    roundoff: the padded sums add exact zeros, in another blocking)."""
    from zig_gpt2_tpu_torch.quant.quantize import dequantize_linear, quantize_params

    cfg = _tcfg(CFG_ODD)
    params = tgpt2.init_params(cfg, torch.Generator().manual_seed(0))
    if weights != "float":
        params = quantize_params(params, weights)
    padded, pcfg = tgpt2.pad_phantom_head(params, cfg)
    assert pcfg.attn_heads == 4 and pcfg.n_heads == 3
    attn = padded["blocks"]["attn"]
    dense = {name: attn[name]["w"] if weights == "float" else
             dequantize_linear(attn[name])["w"] for name in ("wq", "wk", "wv", "c_proj")}
    for name in ("wq", "wk", "wv"):
        assert dense[name].shape[-1] == 256 and not dense[name][..., 192:].any()
        assert not attn[name]["b"][..., 192:].any()
    assert dense["c_proj"].shape[-2] == 256 and not dense["c_proj"][..., 192:, :].any()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32))
    np.testing.assert_allclose(tgpt2.forward(padded, toks, pcfg).numpy(),
                               tgpt2.forward(params, toks, cfg).numpy(), rtol=1e-5, atol=1e-5)
    assert tgpt2.pad_phantom_head(padded, pcfg) == (padded, pcfg)  # even: unchanged


def test_packed_steps_refuse_an_odd_head_count_in_the_weights():
    cfg = dataclasses.replace(_tcfg(CFG_ODD), kv_packed=True)
    params = tgpt2.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tgpt2.init_kv_cache(cfg, 1, 16)
    with pytest.raises(ValueError, match="pad_phantom_head"):
        tgpt2.prefill(params, cache, torch.zeros((1, 4), dtype=torch.int32),
                      torch.tensor([4], dtype=torch.int32), cfg)
    with pytest.raises(ValueError, match="pad_phantom_head"):
        tgpt2.decode_step(params, cache, torch.zeros((1,), dtype=torch.int32), cfg)


# --- runtimes -------------------------------------------------------------------

@pytest.mark.parametrize("cfg,kv_quant", [("even", "int8"), ("odd", None)],
                         ids=["even-int8", "odd-float"])
def test_engine_greedy_tokens_identical_to_jax(monkeypatch, cfg, kv_quant):
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    monkeypatch.setenv("ZG2_KV_PACKED", "1")
    cfg = CFGS[cfg]
    jp, tp = _params(cfg)
    kw = dict(max_seq=32, prompt_buckets=(8,), kv_quant=kv_quant)
    jeng = JEngine(cfg, jp, **kw)
    teng = InferenceEngine(_tcfg(cfg), tp, device="cpu", **kw)
    assert jeng.config.kv_packed and teng.config.kv_packed
    assert teng.new_cache()["k"].shape[2] == (cfg.n_heads + 1) // 2
    for prompt in ([1, 2, 3, 4], [100, 7]):
        want = jeng.generate(prompt, 12, JSampling(temperature=0.0))
        assert teng.generate(prompt, 12, GREEDY) == want


@pytest.mark.parametrize("cfg,kv_quant", [("odd", "int8"), ("even", None)],
                         ids=["odd-int8", "even-float"])
def test_batcher_greedy_tokens_identical_to_jax_past_the_wrap(monkeypatch, rng, cfg,
                                                              kv_quant):
    """Eight requests x 10 tokens through two ring slots of R = 25 rows: the
    write pointer wraps, and each admission splices a packed lane into the
    ring across it."""
    monkeypatch.setenv("ZG2_FUSED_ATTN", "interpret")
    monkeypatch.setenv("ZG2_KV_PACKED", "1")
    cfg = CFGS[cfg]
    jp, tp = _params(cfg)
    kw = dict(batch_size=2, max_seq=24, prompt_buckets=(8,), kv_quant=kv_quant)
    jb = JBatcher(cfg, jp, sampling=JSampling(temperature=0.0), **kw)
    tb = ContinuousBatcher(_tcfg(cfg), tp, sampling=GREEDY, device="cpu", **kw)
    assert jb.config.kv_packed and tb.config.kv_packed and jb._ring and tb._ring
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (3, 7, 5, 8, 4, 6, 2, 8)]
    out = []
    for b in (jb, tb):
        rids = [b.submit(p, 10) for p in prompts]
        by_rid = {r.rid: r.generated for r in b.run()}
        out.append([by_rid[r] for r in rids])
    assert out[1] == out[0]
    rows = tb.cache["k"].shape[-2]
    assert rows == 25 and tb.metrics.steps > rows


# --- layout policy ---------------------------------------------------------------

@pytest.mark.parametrize("env,device,n_embed,want", [
    ("auto", "cpu", 128, False), ("auto", "cuda", 128, True), ("1", "cpu", 128, True),
    ("0", "cuda", 128, False), ("1", "cpu", 64, False), ("auto", "cuda", 64, False)])
def test_default_kv_packed_policy(monkeypatch, env, device, n_embed, want):
    """``auto`` packs on the card at head_dim 64; ``1`` wherever head_dim is
    64; ``0`` never; head_dim 32 (n_embed 64) never. No card is needed to
    decide."""
    monkeypatch.setenv("ZG2_KV_PACKED", env)
    cfg = tconfig.GPTConfig(vocab_size=64, context_size=16, n_layers=1, n_heads=2,
                            n_embed=n_embed)
    assert tgpt2.default_kv_packed(cfg, device) is want


def test_packed_layout_raises_where_it_cannot_run(monkeypatch):
    cfg = _tcfg(dataclasses.replace(CFG_EVEN, kv_packed=True))
    monkeypatch.setenv("ZG2_KV_PACKED", "1")
    # Two heads over tp=2: one per rank, odd, so a mesh serves them unpacked.
    assert not tgpt2.default_kv_packed(_tcfg(CFG_EVEN), "cpu", tp=2)
    with pytest.raises(ValueError, match="even head count per rank"):
        tgpt2.default_kv_packed(cfg, "cpu", tp=2)
    narrow = tconfig.GPTConfig(vocab_size=64, context_size=16, n_layers=1, n_heads=2,
                               n_embed=64, kv_packed=True)
    with pytest.raises(ValueError, match="head_dim 64"):
        tgpt2.default_kv_packed(narrow, "cuda")
    monkeypatch.setenv("ZG2_KV_PACKED", "yes")
    with pytest.raises(ValueError, match="ZG2_KV_PACKED"):
        tgpt2.default_kv_packed(_tcfg(CFG_EVEN), "cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ContinuousBatcher(cfg, {}, device="cpu", mesh=object())


# --- the measurement scripts' CPU-side pieces -------------------------------------

@pytest.mark.parametrize("kind", ["engine", "batcher"])
def test_layout_ab_runs_give_one_layout_each_and_equal_float_tokens(monkeypatch, kind):
    """``tools/layout_ab.py``'s runs on the CPU at a tiny size: each run
    serves the layout ZG2_KV_PACKED asks for, and with a float cache both
    layouts give the same greedy tokens."""
    from zig_gpt2_tpu_torch import config as config_mod
    from zig_gpt2_tpu_torch.runtime import batcher as batcher_mod
    from zig_gpt2_tpu_torch.runtime import engine as engine_mod
    from zig_gpt2_tpu_torch.tools import layout_ab

    cfg = _tcfg(CFG_ODD)
    params = tgpt2.init_params(cfg, torch.Generator().manual_seed(0))
    reqs = layout_ab.requests(1, 4, cfg.vocab_size, (3, 9), (4, 8))
    rows = []
    for layout in ("0", "1"):
        monkeypatch.setenv("ZG2_KV_PACKED", layout)
        if kind == "engine":
            row = layout_ab.run_engine(engine_mod, config_mod, cfg, params,
                                       dict(max_seq=32, prompt_buckets=(16,)),
                                       [ids for ids, _ in reqs[:2]], device="cpu")
        else:
            row = layout_ab.run_batcher(batcher_mod, config_mod, cfg, params,
                                        dict(batch_size=2, max_seq=24,
                                             prompt_buckets=(16,)), reqs, device="cpu")
        assert row["kv_packed"] is (layout == "1")
        rows.append(row)
    assert rows[0]["tokens"] == rows[1]["tokens"]


def test_kernel_ab_register_report_names_each_kernel():
    from zig_gpt2_tpu_torch.tools.kernel_ab import register_report

    log = ("ptxas info    : Compiling entry function 'kern_a' for 'sm_90a'\n"
           "ptxas info    : Function properties for kern_a\n"
           "ptxas info    : Used 110 registers, used 1 barriers, 4160 bytes smem\n"
           "ptxas info    : Compiling entry function 'kern_b' for 'sm_90a'\n"
           "ptxas info    : Used 48 registers, used 1 barriers, 1088 bytes smem\n")
    assert register_report(log) == [
        ("kern_a", "Used 110 registers, used 1 barriers, 4160 bytes smem"),
        ("kern_b", "Used 48 registers, used 1 barriers, 1088 bytes smem")]
