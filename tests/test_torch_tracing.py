"""The port's host spans (``utils.profiling.span``) at the batcher's and the
model's layer boundaries, on the nano config (CPU).

Oracles: the span tree's parents follow the batcher's call structure; an
admission's rows and padded rows follow from the submitted prompts and the
buckets; a decode dispatch's ``kv_rows_live`` equals the cache's lengths
over the occupied lanes; greedy tokens do not change when spans record;
nothing records outside a profiler session and nothing of the spans shows
among the profiler's own events. The benchmark's readers of the spans
(``portbench/metrics``) are held to hand-computed values on hand-built
windows, and ``portbench.trace`` puts a planted idle gap down to the
program span the host was in.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import trace
from portbench.serve import Window
from portbench.spec import Bench
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine
from zig_gpt2_tpu_torch.utils import profiling
from zig_gpt2_tpu_torch.utils.profiling import Span
from zig_gpt2_tpu_torch.weights import tree_map

TCFG = tconfig.GPT2_NANO
GREEDY = SamplingConfig(temperature=0.0)
PREFIX = [41, 7, 13, 29, 3, 17, 23, 11, 5, 2]


@pytest.fixture(scope="module")
def params():
    """GPT2_NANO's initialization times 3, so that greedy streams differ
    per prompt."""
    return tree_map(lambda t: t * 3.0, gpt2.init_params(TCFG, torch.Generator().manual_seed(0)))


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _prompts(lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, TCFG.vocab_size, (n,), generator=g).tolist() for n in lengths]


def _batcher(params, monkeypatch, ring=True, **kw):
    monkeypatch.setenv("ZG2_RING", "1" if ring else "0")
    kw.setdefault("batch_size", 4)
    return ContinuousBatcher(TCFG, params, max_seq=48, prompt_buckets=(8, 16, 32),
                             sampling=GREEDY, device="cpu", **kw)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _named(records, name):
    return [r for r in records if r.name == name]


def test_nothing_recorded_without_a_profiler(params, monkeypatch):
    b = _batcher(params, monkeypatch)
    for p in _prompts((3, 9, 12)):
        b.submit(p, 4)
    b.run()
    assert not profiling.recording()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
    with profiling.span("x", a=1) as a:
        assert a is None
    profiling.record("request", 0.0, 1.0, rid=0)
    assert profiling.spans() == []


def test_step_span_tree(params, monkeypatch):
    """A step that admits: batcher.step holds admit (admit_group: the
    prefill, the splice, the first draw), decode (the decode step, the
    draw), sync and consume, in that order, each after the one before."""
    b = _batcher(params, monkeypatch)
    for p in _prompts((3, 7)):  # one bucket: one admission
        b.submit(p, 3)
    _traced(b.step)
    recs = profiling.spans()
    names = [r.name for r in recs]
    assert names == ["batcher.step", "batcher.admit", "batcher.admit_group", "model.prefill",
                     "batcher.splice", "batcher.sample", "batcher.decode", "model.decode_step",
                     "batcher.sample", "batcher.sync", "batcher.consume"]
    parents = [None if r.parent is None else names[r.parent] for r in recs]
    assert parents == [None, "batcher.step", "batcher.admit", "batcher.admit_group",
                       "batcher.admit_group", "batcher.admit_group", "batcher.step",
                       "batcher.decode", "batcher.decode", "batcher.step", "batcher.step"]
    for r in recs:
        assert r.t0 <= r.t1
        if r.parent is not None:
            assert recs[r.parent].t0 <= r.t0 and r.t1 <= recs[r.parent].t1
    siblings = [r for r in recs if r.parent == 0]
    assert all(a.t1 <= c.t0 for a, c in zip(siblings, siblings[1:]))
    assert _named(recs, "model.prefill")[0].attrs == {"B": 2, "T": 8}
    assert _named(recs, "model.decode_step")[0].attrs == {"B": 4, "T": 1, "graph": 0}
    assert _named(recs, "batcher.consume")[0].attrs == {"tokens": 2, "retired": 0}


def test_request_spans(params, monkeypatch):
    """One ``request`` span per retired request, submit to retirement."""
    b = _batcher(params, monkeypatch, batch_size=2)
    prompts = _prompts((3, 9, 5))
    rids = [b.submit(p, n) for p, n in zip(prompts, (2, 4, 3))]
    done, _ = _traced(b.run)
    reqs = {r.attrs["rid"]: r for r in _named(profiling.spans(), "request")}
    assert sorted(reqs) == rids
    for req in done:
        r = reqs[req.rid]
        assert r.parent is None and r.t0 == req.submitted_at < r.t1
        assert r.attrs == {"rid": req.rid, "prompt_rows": len(req.prompt_ids),
                           "tokens": len(req.generated)}
    consumes = _named(profiling.spans(), "batcher.consume")
    assert sum(c.attrs["retired"] for c in consumes) == 3
    assert sum(c.attrs["tokens"] for c in consumes) == 2 + 4 + 3


@pytest.mark.parametrize("lengths", [(3, 9, 5, 12, 20, 7, 30), (16, 1, 8, 9)],
                         ids=["mixed", "edges"])
def test_admit_group_rows(params, monkeypatch, lengths):
    b = _batcher(params, monkeypatch, batch_size=8)
    prompts = _prompts(lengths)
    for p in prompts:
        b.submit(p, 2)
    _traced(b.run)
    groups = _named(profiling.spans(), "batcher.admit_group")
    assert sorted(rid for g in groups for rid in g.attrs["rids"]) == list(range(len(prompts)))
    for g in groups:
        a = g.attrs
        want = sum(len(prompts[rid]) for rid in a["rids"])
        assert a["k"] == len(a["rids"]) and a["rows"] == want
        assert a["padded"] == a["k"] * a["bucket"] - want
        assert all(len(prompts[rid]) <= a["bucket"] for rid in a["rids"])
        assert a["bucket"] == min(x for x in (8, 16, 32)
                                  if x >= max(len(prompts[rid]) for rid in a["rids"]))


def test_admit_prefix_rows(params, monkeypatch):
    b = _batcher(params, monkeypatch, batch_size=4)
    b.register_prefix(PREFIX)
    suffixes = _prompts((2, 7, 12, 1), seed=1)
    prompts = [PREFIX + s for s in suffixes]
    for p in prompts:
        b.submit(p, 2)
    _traced(b.run)
    hits = _named(profiling.spans(), "batcher.admit_prefix")
    assert sorted(rid for h in hits for rid in h.attrs["rids"]) == [0, 1, 2, 3]
    for h in hits:
        a = h.attrs
        usable = {rid: b._match_prefix(prompts[rid])[1] for rid in a["rids"]}
        rows = sum(len(prompts[rid]) - usable[rid] for rid in a["rids"])
        assert a["rows"] == rows and a["prefix_rows"] == sum(usable.values())
        assert a["padded"] == a["k"] * a["bucket"] - rows
        assert _named([r for r in profiling.spans() if r.parent == profiling.spans().index(h)],
                      "model.extend")[0].attrs == {"B": a["k"], "T": a["bucket"]}
    assert not _named(profiling.spans(), "batcher.admit_group")
    assert sum(h.attrs["prefix_rows"] for h in hits) == b.metrics.prefill_tokens_saved


@pytest.mark.parametrize("ring,chunk", [(True, 1), (False, 1), (True, 3)],
                         ids=["ring", "linear", "ring-chunk3"])
def test_kv_rows_live(params, monkeypatch, ring, chunk):
    """Each decode dispatch's kv_rows_live is the sum of the cache's lengths
    over the occupied lanes as its first decode step starts."""
    b = _batcher(params, monkeypatch, ring=ring, batch_size=3, decode_chunk=chunk)
    seen = []
    decode_step = gpt2.decode_step

    def spy(p, cache, tokens, config):
        lens = cache["length"].tolist()
        seen.append(sum(lens[i] for i, r in enumerate(b.slots) if r is not None))
        return decode_step(p, cache, tokens, config)

    monkeypatch.setattr(gpt2, "decode_step", spy)
    for p, n in zip(_prompts((3, 9, 5, 12, 7)), (5, 2, 7, 3, 4)):
        b.submit(p, n)
    _traced(b.run)
    decodes = _named(profiling.spans(), "batcher.decode")
    assert [d.attrs["kv_rows_live"] for d in decodes] == seen[::chunk]
    assert all(d.attrs["kv_rows_reserved"] == 3 * b._cache_rows for d in decodes)
    assert all(0 < d.attrs["lanes"] <= 3 for d in decodes)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_greedy_tokens_identical_with_recording(params, monkeypatch, kv_quant):
    prompts = _prompts((3, 9, 5, 12, 7, 20))

    def serve():
        b = _batcher(params, monkeypatch, batch_size=2, kv_quant=kv_quant)
        b.register_prefix(prompts[1][:6])
        rids = [b.submit(p, 6) for p in prompts]
        by = {r.rid: r.generated for r in b.run()}
        return [by[r] for r in rids]

    off = serve()
    on, _ = _traced(serve)
    assert on == off and _named(profiling.spans(), "batcher.decode")


def test_speculative_step_spans(params, monkeypatch):
    b = _batcher(params, monkeypatch, batch_size=2, speculative="ngram", spec_min_tpr=0.0)
    for p in _prompts((5, 9)):
        b.submit(p, 4)
    _traced(b.step)
    recs = profiling.spans()
    steps = [i for i, r in enumerate(recs) if r.name == "batcher.step"]
    syncs = _named(recs, "batcher.sync")
    assert len(steps) == 1 and len(syncs) == 1 and syncs[0].parent == steps[0]
    assert _named(recs, "model.extend")


def test_engine_gets_model_spans(params):
    eng = InferenceEngine(TCFG, params, None, max_seq=48, device="cpu")
    out, _ = _traced(lambda: eng.generate(_prompts((5,))[0], 3, GREEDY))
    recs = profiling.spans()
    assert len(out) == 3
    assert [r.attrs for r in _named(recs, "model.prefill")] == [{"B": 1, "T": 32}]
    decodes = _named(recs, "model.decode_step")
    assert decodes and all(r.attrs == {"B": 1, "T": 1, "graph": 0} for r in decodes)


def test_spans_put_nothing_among_the_profilers_events(params, monkeypatch):
    b = _batcher(params, monkeypatch)
    for p in _prompts((3, 9)):
        b.submit(p, 3)
    _, prof = _traced(b.run)
    assert _named(profiling.spans(), "batcher.step")
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.startswith(("batcher.", "model.", "request"))}


def test_the_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)

    def nest():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
            with profiling.span("c") as c:
                with profiling.span("d") as d:  # past the cap
                    assert d == {}
                c["x"] = 1
        profiling.record("e", 0.0, 1.0)

    _traced(nest)
    assert [(r.name, r.parent, r.attrs) for r in profiling.spans()] == [
        ("a", None, {}), ("b", 0, {}), ("c", 0, {"x": 1})]
    assert profiling.dropped_spans() == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_profiler_trace_writes_the_spans(params, monkeypatch, tmp_path):
    b = _batcher(params, monkeypatch, batch_size=2)
    for p in _prompts((3, 9, 5)):
        b.submit(p, 3)
    b.step()
    _traced(lambda: profiling.record("before", 0.0, 1.0))  # kept, but before the block
    with profiling.profiler_trace(str(tmp_path), device="cpu"):
        done = b.run()
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    names = [e["name"] for e in events]
    assert names.count("request") == len(done) == 3 and "before" not in names
    steps = [i for i, e in enumerate(events) if e["name"] == "batcher.step"]
    assert steps and all(events[i]["args"]["parent"] is None for i in steps)
    for e in events:
        p = e["args"]["parent"]
        if p is not None:
            assert events[p]["tid"] == e["tid"]
            assert events[p]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= (
                events[p]["ts"] + events[p]["dur"] + 1e-3)
    assert any("rids" in e["args"] for e in events if e["name"] == "batcher.admit_group")


def test_chrome_spans_rows():
    """A span shares its parent's row; requests, kept as they retire inside
    a step and overlapping steps without nesting in them, take another."""
    recs = [Span("step", 1.0, 2.0), Span("inner", 1.2, 1.5, 0), Span("req0", 0.0, 1.8),
            Span("step", 3.0, 4.0), Span("req1", 2.5, 3.9), Span("step", 6.0, 7.0)]
    events = profiling.chrome_spans(recs)["traceEvents"]
    assert [e["tid"] for e in events] == [0, 0, 1, 0, 1, 0]
    assert events[1]["args"] == {"parent": 0} and events[1]["ts"] == pytest.approx(1.2e6)
    assert events[1]["dur"] == pytest.approx(0.3e6)
    moved = profiling.chrome_spans(recs[1:], first=1)["traceEvents"]
    assert moved[0]["args"]["parent"] is None and moved[0]["tid"] == 0


# -- the benchmark's readers and trace reduction on program spans -------------------

def _step_records(t, admit=None, sync=0.004, decode_attrs=None, extra_step=0.0, graph=None):
    """One batcher step at host time t, its records' parents indices among
    them: the step [t, t + 0.020 + extra_step], an admission (a 3 ms
    prefill) if ``admit``, a decode dispatch with a 6 ms model step (its
    ``graph`` attribute if given), a sync of ``sync`` seconds."""
    recs = [Span("batcher.step", t, t + 0.020 + extra_step, None)]

    def add(name, t0, t1, parent, **attrs):
        recs.append(Span(name, t0, t1, parent, attrs))
        return len(recs) - 1

    admit_i = add("batcher.admit", t + 0.001, t + 0.006, 0)
    if admit is not None:
        name, attrs = admit
        g = add(name, t + 0.001, t + 0.006, admit_i, **attrs)
        add("model.prefill", t + 0.002, t + 0.005, g)
    d = add("batcher.decode", t + 0.006, t + 0.014, 0, **(decode_attrs or {}))
    add("model.decode_step", t + 0.007, t + 0.013, d,
        **({} if graph is None else {"graph": graph}))
    add("batcher.sync", t + 0.014, t + 0.014 + sync, 0)
    return recs


def _window(step_recs, inside=None):
    """All the steps' records in one list (parents offset), and a window
    whose traced steps are those ``inside`` (default all)."""
    records, steps = [], []
    for k, recs in enumerate(step_recs):
        off = len(records)
        for r in recs:
            records.append(Span(r.name, r.t0, r.t1, None if r.parent is None else r.parent + off,
                                dict(r.attrs)))
        if inside is None or k in inside:
            steps.append(trace.TracedStep(recs[0].t0 - 0.0005, recs[0].t1 + 0.0005, [],
                                          0.0, 0.0, {}))
    w = Window(config={}, batch=4, seconds=1.0, counters={}, sync_ms=[], prompt_tokens=0,
               flops=0.0, steps=steps)
    return records, w


def _read(name, w):
    return Bench().reader(name)(w)


def _three_steps(graph=None):
    return [
        _step_records(1.0, ("batcher.admit_group", dict(k=2, bucket=32, rows=40, padded=24)),
                      sync=0.002, decode_attrs=dict(kv_rows_live=100, kv_rows_reserved=400),
                      graph=graph),
        _step_records(2.0, None, sync=0.004,
                      decode_attrs=dict(kv_rows_live=110, kv_rows_reserved=400), graph=graph),
        _step_records(3.0, ("batcher.admit_prefix", dict(k=1, bucket=128, rows=100, padded=28,
                                                         prefix_rows=448)),
                      sync=0.010, decode_attrs=dict(kv_rows_live=90, kv_rows_reserved=400),
                      extra_step=0.006, graph=graph),
    ]


@pytest.mark.parametrize("name,want", [
    ("sync_wait_ms_p50", 4.0),
    # the steps' 20, 20 and 26 ms less their model.prefill (3, none, 3),
    # model.decode_step (6 each) and sync (2, 4, 10): 9, 10 and 7 ms
    ("batcher_host_ms_p50", 9.0),
    ("padded_row_share", 100.0 * (24 + 28) / (64 + 128)),
    ("kv_row_share", 100.0 * 300 / 1200),
])
def test_span_readers(monkeypatch, name, want):
    records, w = _window(_three_steps())
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert _read(name, w) == pytest.approx(want)


@pytest.mark.parametrize("graphs,want", [
    ((1, 1, 1), 100.0),
    ((1, 0, 1), 200.0 / 3),
    ((0, 0, 0), 0.0),
    ((None, None, None), None),  # a program whose decode spans carry no graph flag
], ids=["replayed", "one-eager", "eager", "no-flag"])
def test_decode_graph_share_reader(monkeypatch, graphs, want):
    """The share of the traced steps' decode steps that replay the graph;
    a capture's eager warm-up step counts as eager."""
    records, w = _window([_step_records(1.0 + k, graph=g) for k, g in enumerate(graphs)])
    monkeypatch.setattr(profiling, "spans", lambda: records)
    got = _read("decode_graph_share", w)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", ["sync_wait_ms_p50", "batcher_host_ms_p50",
                                  "padded_row_share", "kv_row_share", "decode_graph_share"])
def test_span_readers_read_nothing(monkeypatch, name):
    records, w = _window(_three_steps(graph=1), inside=())
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert _read(name, w) is None  # no traced step
    records, w = _window(_three_steps(graph=1))
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(name, w) is None  # no spans
    monkeypatch.delattr(profiling, "spans")
    assert _read(name, w) is None  # a program without the recorder


def test_span_readers_keep_to_the_traced_steps(monkeypatch):
    records, w = _window(_three_steps(), inside=(0,))
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert _read("sync_wait_ms_p50", w) == pytest.approx(2.0)
    assert _read("padded_row_share", w) == pytest.approx(100.0 * 24 / 64)
    assert _read("kv_row_share", w) == pytest.approx(25.0)


def test_idle_gap_put_down_to_the_program_span():
    """Program records as ``portbench.trace``'s span log, on one host clock
    with the step markers: the device idles 0.01-2 ms after the step's
    marker while the host is in model.decode_step, 3.5-9 ms while it is in
    batcher.sync (the model span has ended) and 11-12 ms in the step's own
    work."""
    t = 10.0
    recs = [Span("batcher.step", t, t + 0.012), Span("batcher.decode", t + 0.0005, t + 0.004, 0),
            Span("model.decode_step", t + 0.0006, t + 0.0039, 1),
            Span("batcher.sync", t + 0.004, t + 0.0095, 0)]
    log = [(r.name, r.t0, r.t1) for r in recs]
    marks = [(t, {}), (t + 0.012, {})]
    ms = 1_000_000
    base = 5_000 * ms  # the device clock runs from another origin
    dev = [(0, base, 10_000, "spin_kernel"),        # this step's marker, at host t
           (1, base + 2 * ms, 1 * ms, "gemm"),
           (2, base + 3 * ms, ms // 2, "attention"),
           (3, base + 9 * ms, 2 * ms, "lm_head"),
           (4, base + 12 * ms, 10_000, "spin_kernel")]  # the next step's marker
    (st,) = trace._steps(dev, trace._Spans(log), marks)
    assert st.busy_s == pytest.approx(0.0035)
    gaps = dict(trace.breakdown([st])["idle_gaps"])
    assert gaps == pytest.approx({"model.decode_step": 0.00199, "batcher.sync": 0.0055,
                                  "batcher.step": 0.001})


def test_traced_nano_run_reads_the_span_metrics(tmp_path, monkeypatch):
    """A whole traced run of a nano prefix cell (``portbench.run.run`` on the
    CPU, the profiler on the host): the four span readers report numbers.
    With no device markers to split at, each stretch's steps are taken
    from its host marks alone."""
    from portbench import run
    from portbench.tests import nano

    def host_steps(dev, spans, marks):
        return [trace.TracedStep(m0, m1, [], 0.0, 0.0, {})
                for (m0, _), (m1, _) in zip(marks, marks[1:])]

    monkeypatch.setenv("ZG2_KV_PACKED", "1")
    monkeypatch.setattr(trace, "ACTIVITIES", ("CPU",))
    monkeypatch.setattr(trace, "_steps", host_steps)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    r = run.run("nanoq-prefix", 2 ** 31 + 7, 1.5, True, device="cpu",
                root=nano.make(tmp_path), t_start=0.0)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0.0 < m["sync_wait_ms_p50"] and 0.0 < m["batcher_host_ms_p50"]
    assert 0.0 < m["padded_row_share"] < 100.0
    assert 0.0 < m["kv_row_share"] < 100.0
