"""Each per-layer reader on a synthetic window, against a hand-computed value,
and the trace reduction on synthetic profiler events."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from portbench import roofline, trace
from portbench.serve import Window
from portbench.spec import Bench

ROOT = Path(__file__).resolve().parents[2]
XL = json.loads((ROOT / "portbench" / "configs" / "gpt2-xl-int4-kv8.json").read_text())
QMM = "void qmm_mma_kernel<4, 2>(QArgs)"
ATTN = "void decode_attention_kernel<1, 2>(Args)"


def step(kernels, busy, span, qmm_calls=None):
    return trace.TracedStep(0.0, 1.0, kernels, busy, span, qmm_calls or {})


def window(**kw):
    base = dict(config=XL, batch=4, seconds=2.0,
                counters={"steps": 10, "occupied_slot_steps": 30, "prefill_s": 0.5,
                          "prefix_hits": 2, "prefill_tokens_saved": 60, "sync_count": 10},
                sync_ms=[5.0, 1.0, 3.0, 9.0], prompt_tokens=80, flops=4e12)
    base.update(kw)
    return Window(**base)


def read(name, w):
    return Bench(ROOT).reader(name)(w)


def test_batcher_readers():
    w = window()
    assert read("slot_utilization", w) == pytest.approx(75.0)
    assert read("admission_share", w) == pytest.approx(25.0)
    assert read("prefix_token_share", w) == pytest.approx(75.0)
    assert read("decode_step_ms_p50", w) == pytest.approx(4.0)
    assert read("mfu", w) == pytest.approx(100.0 * 4e12 / (2.0 * 989e12))


def test_nothing_to_read():
    w = window(counters={"steps": 0, "occupied_slot_steps": 0, "prefill_s": 0.0,
                         "prefix_hits": 0, "prefill_tokens_saved": 0, "sync_count": 0},
               sync_ms=[], flops=0.0)
    for name in ("slot_utilization", "prefix_token_share", "decode_step_ms_p50", "mfu",
                 "kernels_per_step", "qmm_roofline", "attention_roofline", "device_idle"):
        assert read(name, w) is None, name


@pytest.mark.parametrize("name", ["ttft_ms_p95", "tokens_per_s", "itl_ms_p95"])
def test_host_tail_reader(name):
    """A host-clock end-to-end number kept per layer in the cells too noisy
    for a bound on it: read back as the window measured it."""
    reader = f"{name}.host"
    assert read(reader, window(end_to_end={name: 412.5})) == 412.5
    assert read(reader, window(end_to_end={name: math.nan})) is None
    assert read(reader, window()) is None


def test_end_to_end_by_hand():
    """The clients' numbers over a window of known token times: two
    requests, one token before the window opens."""
    from portbench.serve import Served, measure
    from portbench.traffic import Request

    a = Served(Request(0, [1] * 8, 4, 0), 0.5, 8, times=[0.9, 1.2, 1.25, 1.3],
               tokens=[1, 2, 3, 4])
    b = Served(Request(1, [1] * 4, 3, 0), 1.0, 4, times=[1.5, 1.6, 2.6], tokens=[5, 6, 7])
    e2e, prompt_tokens, flops = measure(XL, [a, b], 1.0, 3.0)
    gaps = [50.0, 50.0, 100.0, 1000.0]  # a: 1.2->1.25->1.3; b: 1.5->1.6->2.6 (ms)
    assert e2e["tokens_per_s"] == pytest.approx(6 / 2.0)
    assert e2e["ttft_ms_p95"] == pytest.approx(500.0)  # b alone: a's first is before
    assert e2e["itl_ms_p95"] == pytest.approx(float(np.percentile(gaps, 95)))
    assert e2e["itl_ms_p10"] == pytest.approx(50.0)
    assert prompt_tokens == 4 and flops > 0


def test_trace_readers():
    shape = ("int4", 1600, 6400, 128)
    steps = [step([(QMM, 0.004), (ATTN, 0.001), ("Memcpy HtoD", 0.0005), ("gemv", 0.001)],
                  busy=0.0065, span=0.010, qmm_calls={shape: 2}),
             step([(QMM, 0.002), ("gemv", 0.001)], busy=0.003, span=0.010)]
    w = window(steps=steps, step_tokens=[[100, 300], []])
    assert read("kernels_per_step", w) == pytest.approx(2.5)  # 3 + 2 kernels, copies left out
    assert read("device_idle", w) == pytest.approx(100 * (1 - 0.0095 / 0.020))
    qmm_bound = 2 * roofline.qmm_call(XL, *shape)
    assert read("qmm_roofline", w) == pytest.approx(100 * qmm_bound / 0.006)
    attn_bound = (roofline.decode_attention_lane(XL, 100)
                  + roofline.decode_attention_lane(XL, 300))
    assert read("attention_roofline", w) == pytest.approx(100 * attn_bound / 0.001)


class _Host:
    def at(self, t):
        return "host"


def test_steps_split_at_markers_and_drop_a_cut_step():
    # A stretch of 3 steps (4 markers) whose first marker was lost: the
    # kernels before the first surviving marker belong to no step.
    us = 1000
    dev = [(1, 0, 5 * us, "qmm_mma_kernel lost"),
           (2, 10 * us, 1 * us, "spin_kernel"), (3, 12 * us, 4 * us, QMM),
           (4, 20 * us, 2 * us, ATTN),
           (5, 30 * us, 1 * us, "spin_kernel"), (6, 35 * us, 5 * us, QMM),
           (7, 50 * us, 1 * us, "spin_kernel")]
    marks = [(0.0, {}), (1.0, {}), (2.0, {("int4", 8, 8, 1): 3}), (3.0, {("int4", 8, 8, 1): 5})]
    steps = trace._steps(dev, _Host(), marks)
    assert len(steps) == 2
    a, b = steps
    assert [n for n, _ in a.kernels] == [QMM, ATTN]
    assert a.busy_s == pytest.approx(6e-6) and a.span_s == pytest.approx(20e-6)
    assert [sec for _, sec in a.gaps] == pytest.approx([1e-6, 4e-6, 8e-6])
    assert a.qmm_calls == {("int4", 8, 8, 1): 3}
    assert b.qmm_calls == {("int4", 8, 8, 1): 2}
    assert (a.t0, a.t1, b.t0, b.t1) == (1.0, 2.0, 2.0, 3.0)
    assert b.busy_s == pytest.approx(5e-6) and b.span_s == pytest.approx(20e-6)
    bd = trace.breakdown(steps)
    assert bd["device_ops"][0] == [QMM, pytest.approx(9e-6)]
    assert bd["idle_gaps"] == [["host", pytest.approx(27e-6)]]
