"""The decode step's CUDA graph (``runtime.decode_graph``), its CPU side.

- ``decode_step`` updates the cache's ``length`` and ``wptr`` in place: the
  same tensors across steps (a graph replays into them), with the values
  the step always gave, ring and linear, float and INT8.
- A CPU batcher builds no graph and emits the port engine's greedy tokens.
- Where a batcher replays a graph: a card without a mesh or model group.
- The launch tallies (``ops.tallies``): every kernel wrapper registers
  its own; one step's count taken from a capture and added per replay
  equals counting every step, on the plain paths of the CPU (which count
  nothing) and on a step that counts as the card's kernels do.
- The graph's key follows the switches the step reads at each call, and
  the batcher keeps the cache the step returns (the graph's eager
  fallback included).

The card's side (bit-identical logits, counts, the speculative hand-over)
is in ``tests/test_torch_cuda.py``.
"""

import collections
import dataclasses

import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.ops import attention as att
from zig_gpt2_tpu_torch.ops import sampling_kernel as sk
from zig_gpt2_tpu_torch.ops import tallies
from zig_gpt2_tpu_torch.quant import kernels as qk
from zig_gpt2_tpu_torch.runtime import decode_graph
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine

CFG = tconfig.GPT2_NANO
GREEDY = SamplingConfig(temperature=0.0)


@pytest.fixture(scope="module")
def params():
    p = gpt2.init_params(CFG, torch.Generator().manual_seed(5))
    return {**p, "wte": p["wte"] * 3}


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "linear"])
def test_decode_step_updates_length_and_wptr_in_place(params, ring, kv_quant):
    """Twelve steps on a 10-row cache: the ring's length clamps at rows - 1
    and its write row wraps; the linear length counts on. The cache dict
    keeps the same tensors at the same addresses throughout."""
    cfg = dataclasses.replace(CFG, ring_cache=ring)
    rows, lanes = 10, 3
    cache = gpt2.init_kv_cache(cfg, lanes, rows, quant=kv_quant)
    cache["length"].copy_(torch.tensor([0, 2, 5], dtype=torch.int32))
    if ring:
        cache["start"].copy_(torch.tensor([0, 7, 3], dtype=torch.int32))
        cache["wptr"].fill_(5)
    tensors = dict(cache)
    ptrs = {name: t.data_ptr() for name, t in cache.items()}
    length = [0, 2, 5]
    wptr = 5
    for step in range(12):
        out, logits = gpt2.decode_step(params, cache, torch.tensor([1, 2, 3 + step]), cfg)
        assert out is cache and logits.shape == (lanes, CFG.vocab_rows)
        assert cache.keys() == tensors.keys()
        assert all(cache[n] is t and t.data_ptr() == ptrs[n] for n, t in tensors.items())
        length = [min(n + 1, rows - 1) if ring else n + 1 for n in length]
        assert cache["length"].tolist() == length
        assert cache["length"].dtype == torch.int32
        if ring:
            wptr = (wptr + 1) % rows
            assert cache["wptr"].item() == wptr and cache["wptr"].dtype == torch.int32


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_cpu_batcher_builds_no_graph(params, decode_chunk):
    """Six requests through two slots on the CPU: no graph object, no
    capture or replay counted or shown, and each request's greedy tokens
    are the engine's."""
    b = ContinuousBatcher(CFG, params, batch_size=2, max_seq=48, prompt_buckets=(16,),
                          sampling=GREEDY, decode_chunk=decode_chunk, device="cpu")
    feed = b._tokens
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4], [11, 12, 13, 14], [40, 41], [7] * 9]
    rids = [b.submit(p, 8) for p in prompts]
    got = {r.rid: r.generated for r in b.run()}
    eng = InferenceEngine(CFG, params, max_seq=48, prompt_buckets=(16,), device="cpu")
    assert [got[r] for r in rids] == [eng.generate(p, 8, GREEDY) for p in prompts]
    assert b._graph is None and b._tokens is feed  # one feed vector, written in place
    m = b.metrics
    assert m.decode_graph_captures == m.decode_graph_replays == 0 and m.steps > 0
    assert "decode_graph_captures" not in m.as_dict(2)


class _Mesh:
    dp = 1


@pytest.mark.parametrize("device,mesh,group,want", [
    ("cuda", None, None, True),
    ("cpu", None, None, False),
    ("cuda", _Mesh(), None, False),
    ("cuda", None, object(), False),
], ids=["card", "cpu", "mesh", "model-group"])
def test_graph_is_chosen_by_device_and_mesh_only(device, mesh, group, want):
    fields = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    cfg = CFG if group is None else tconfig.RankConfig(**fields, model_group=group)
    assert decode_graph.usable(torch.device(device), mesh, cfg) is want


def _tallies_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        dict(a[k]) == dict(b[k]) if isinstance(a[k], dict) else a[k] == b[k] for k in a)


def _as_on_card(step):
    """``step`` followed by the counts the card's wrappers would make for
    one 2-lane nano step: per layer the INT8 packed ring attention and
    four INT4 GEMVs, the INT8 lm_head, and one float GEMV."""
    def counted(*args):
        out = step(*args)
        fn = att.decode_attention_quant_deferred
        for _ in range(CFG.n_layers):
            fn.packed_ring_launches += 1
            fn.by_dtype[("packed_ring_launches", "bfloat16", "int8")] += 1
            for k, n in ((64, 64), (64, 64), (64, 256), (256, 64)):
                qk.qmm.launches += 1
                qk.qmm.by_shape[("int4", k, n, 2)] += 1
        qk.qmm.launches += 1
        qk.qmm.by_shape[("int8", 64, CFG.vocab_rows, 2)] += 1
        qk.wmm.launches += 1
        qk.wmm.by_shape[("float32", 64, 64, 2)] += 1
        return out
    return counted


@pytest.mark.parametrize("steps", [1, 6])
@pytest.mark.parametrize("counting", [False, True], ids=["cpu-plain", "as-on-card"])
def test_capture_delta_times_replays_equals_eager_tallies(params, monkeypatch, counting,
                                                          steps):
    """The graph's bookkeeping on the plain paths: warm up and 'capture'
    (each one step, counted), take both back out, add the capture's delta
    per replay; the tallies then equal those of ``steps`` eager steps."""
    for fn, name in tallies.snapshot():  # each test from fresh tallies
        value = getattr(fn, name)
        monkeypatch.setattr(fn, name, collections.Counter(value) if isinstance(value, dict)
                            else value)
    qk.qmm.by_shape[("int4", 1600, 1600, 128)] += 3  # a count from before, kept
    step = gpt2.decode_step
    if counting:
        step = _as_on_card(step)
    cfg = dataclasses.replace(CFG, ring_cache=True)

    def run():
        cache = gpt2.init_kv_cache(cfg, 2, 16)
        return lambda: step(params, cache, torch.tensor([3, 4]), cfg)

    start = tallies.snapshot()
    eager = run()
    for _ in range(steps):
        eager()
    want = tallies.snapshot()
    tallies.add(tallies.delta(start, want), -1)
    assert _tallies_equal(tallies.snapshot(), start)

    graphed = run()
    graphed()  # the warm-up
    warm = tallies.snapshot()
    graphed()  # the capture
    done = tallies.snapshot()
    delta = tallies.delta(warm, done)
    assert delta == tallies.delta(start, warm)
    assert bool(delta) == counting
    tallies.add(tallies.delta(start, done), -1)
    assert _tallies_equal(tallies.snapshot(), start)
    for _ in range(steps):
        tallies.add(delta)
    assert _tallies_equal(tallies.snapshot(), want)
    assert qk.qmm.by_shape[("int4", 1600, 1600, 128)] == 3
    assert all(v > 0 for v in qk.qmm.by_shape.values())


def test_tally_delta_removes_keys_it_brings_to_zero(monkeypatch):
    monkeypatch.setattr(qk.wmm, "by_shape", collections.Counter({("float32", 8, 8, 1): 2}))
    monkeypatch.setattr(qk.wmm, "launches", 2)
    before = tallies.snapshot()
    qk.wmm.by_shape[("bfloat16", 8, 8, 4)] += 5
    qk.wmm.launches += 5
    delta = tallies.delta(before, tallies.snapshot())
    assert delta == {(qk.wmm, "by_shape"): {("bfloat16", 8, 8, 4): 5},
                     (qk.wmm, "launches"): 5}
    tallies.add(delta, -1)
    assert qk.wmm.by_shape == collections.Counter({("float32", 8, 8, 1): 2})
    assert ("bfloat16", 8, 8, 4) not in qk.wmm.by_shape and qk.wmm.launches == 2


@pytest.mark.parametrize("wrapper,names", [
    (qk.qmm, ("launches", "w8a8_launches", "by_shape")),
    (qk.wmm, ("launches", "by_shape")),
    (sk.sample_categorical, ("launches", "max_launches")),
    *[(fn, ("launches", "ring_launches", "packed_launches", "packed_ring_launches",
            "by_dtype"))
      for fn in (att.decode_attention_deferred, att.decode_attention_quant_deferred,
                 att.decode_attention, att.decode_attention_quant)],
], ids=["qmm", "wmm", "sampler", "attention-deferred", "attention-quant-deferred",
        "attention", "attention-quant"])
def test_every_kernel_wrapper_registers_its_tallies(wrapper, names):
    """The registry holds each wrapper's tallies, and only they move with
    its count: what a replay has to add cannot be left out of it."""
    snap = tallies.snapshot()
    assert {name for fn, name in snap if fn is wrapper} == set(names)
    assert all(callable(fn) for fn, _ in snap)


def test_counted_zeroes_and_registers(monkeypatch):
    monkeypatch.setattr(tallies, "_REGISTRY", dict(tallies._REGISTRY))

    @tallies.counted("launches", counters=("by_shape",))
    def kernel():
        kernel.launches += 1
        kernel.by_shape[(8, 8)] += 1

    assert kernel.launches == 0 and kernel.by_shape == collections.Counter()
    before = tallies.snapshot()
    kernel()
    kernel()
    change = tallies.delta(before, tallies.snapshot())
    assert change == {(kernel, "launches"): 2, (kernel, "by_shape"): {(8, 8): 2}}
    tallies.add(change, 3)
    assert kernel.launches == 8 and kernel.by_shape[(8, 8)] == 8


@pytest.mark.parametrize("switch,values", [("ZG2_WMM", ("0", "1")), ("ZG2_QMM", ("1", "0"))])
def test_graph_key_follows_the_step_switches(params, monkeypatch, switch, values):
    """A switch that ``decode_step`` reads at each call changes the graph's
    key, so a live batcher captures again rather than replay the old
    kernels; the same tensors under the same switches keep it."""
    cache = gpt2.init_kv_cache(CFG, 2, 16)
    tokens = torch.zeros(2, dtype=torch.int32)
    keys = []
    for value in values + values[:1]:
        monkeypatch.setenv(switch, value)
        keys.append(decode_graph.graph_key(params, cache, tokens))
    assert keys[0] != keys[1] and keys[0] == keys[2]
    moved = dict(cache, length=cache["length"].clone())
    assert decode_graph.graph_key(params, moved, tokens) != keys[0]


def _rebinding(real, new_dict):
    """``decode_step`` that rebinds the cache's length to a new tensor, in
    the same dict or in a new one, and leaves the old tensor as it was."""
    def step(p, cache, tokens, config):
        old = cache["length"].clone()
        cache, logits = real(p, cache, tokens, config)
        length = cache["length"].clone()
        cache["length"].copy_(old)  # the dict given keeps the old lengths
        out = dict(cache) if new_dict else cache
        out["length"] = length
        return out, logits
    return step


@pytest.mark.parametrize("new_dict", [False, True], ids=["same-dict", "new-dict"])
def test_batcher_keeps_the_cache_the_graph_step_returns(params, monkeypatch, new_dict):
    """The graph's eager fallback returns the step's (cache, logits), and the
    batcher serves from the cache it got: a step that rebinds its tensors,
    even into a new dict, gives the plain batcher's greedy tokens. (Large
    position embeddings, so that a stale length changes the tokens.)"""
    params = {**params, "wpe": params["wpe"] * 30}
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4], [11, 12, 13, 14]]
    out = []
    for rebind in (False, True):
        if rebind:
            monkeypatch.setattr(gpt2, "decode_step", _rebinding(gpt2.decode_step, new_dict))
        b = ContinuousBatcher(CFG, params, batch_size=2, max_seq=48, prompt_buckets=(16,),
                              sampling=GREEDY, device="cpu")
        graph = decode_graph.DecodeGraph()
        graph.eager = True  # as a capture that saw the step rebind its cache leaves it
        b._graph = graph
        rids = [b.submit(p, 8) for p in prompts]
        got = {r.rid: r.generated for r in b.run()}
        out.append([got[r] for r in rids])
        assert b.metrics.decode_graph_captures == b.metrics.decode_graph_replays == 0
    assert out[0] == out[1]
