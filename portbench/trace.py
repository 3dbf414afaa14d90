"""The traced run: short profiled stretches spread over the window, reduced in
memory (no trace file is written).

Each stretch opens a ``torch.profiler`` window on the device's activity
only (recording every host op would slow the host-bound steps several
fold), marks each of its batcher steps with a ``torch.cuda._sleep``
kernel, and closes with one marker more. A profiler window can lose the
first kernels launched into it, and a lost marker takes its step with it:
the kernels between two markers that both survive are one whole step, and
the surviving steps are the stretch's last ones.

What the host was doing is read from spans, host-clock intervals of a
stretch: the program's own (``portbench.program_spans``: ``batcher.*`` and
``model.prefill``, ``model.extend``, ``model.decode_step``, a replay of the
decode step's graph included) and the harness's ``portbench.step`` around
each batcher step. Each step starts with the device idle (the step before
ended on a host sync), so its marker starts as it is launched: that ties
the host clock to the device's, and an idle gap on the device is put down
to the innermost span the host was in (``harness`` outside every span).
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from portbench import program_spans

MARK_CYCLES = 1000
_MARK = "spin_kernel"
ACTIVITIES = ("CUDA",)
STRETCHES, STEPS = 8, 3   # profiled stretches a window, batcher steps a stretch
# The program's spans of host work (not ``request``: a request's lifetime).
HOST_SPANS = ("batcher.", "model.")


@dataclass
class TracedStep:
    t0: float                       # host clock at this step's marker and the next
    t1: float
    kernels: List[Tuple[str, float]]  # device ops (name, seconds), launch order
    busy_s: float                   # device time covered by an op
    span_s: float                   # device clock from this step's marker to the next
    qmm_calls: Dict[tuple, int]     # the program's qmm.by_shape over the step
    gaps: List[Tuple[str, float]] = field(default_factory=list)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Tracer:
    def __init__(self, seconds: float):
        self.starts = [(i + 0.5) * seconds / STRETCHES for i in range(STRETCHES)]
        self.log: Optional[list] = None   # (label, host t0, host t1) while a stretch runs
        self._raw = []

    def due(self, elapsed: float) -> bool:
        if self.starts and elapsed >= self.starts[0]:
            self.starts.pop(0)
            return True
        return False

    def span(self, label: str, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)``, logged as a span while a stretch runs."""
        log = self.log
        if log is None:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.append((label, t0, time.perf_counter()))

    def stretch(self, step: Callable[[], None], qmm_counter: Callable[[], Dict]) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        marks, self.log = [], []
        first = len(program_spans.records() or ())
        with profile(activities=[getattr(ProfilerActivity, a) for a in ACTIVITIES]) as prof:
            for _ in range(STEPS):
                marks.append((time.perf_counter(), dict(qmm_counter())))
                torch.cuda._sleep(MARK_CYCLES)
                step()
            marks.append((time.perf_counter(), dict(qmm_counter())))
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        spans = self.log + [(r.name, r.t0, r.t1)
                            for r in (program_spans.records() or ())[first:]
                            if r.name.startswith(HOST_SPANS)]
        self._raw.append((prof, marks, spans))
        self.log = None

    def reduce(self) -> List[TracedStep]:
        from torch.autograd import DeviceType

        out = []
        for prof, marks, log in self._raw:
            dev = sorted((e.correlation_id(), e.start_ns(), e.duration_ns(), e.name())
                         for e in prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA
                         and not e.name().startswith("portbench."))
            out.extend(_steps(dev, _Spans(log), marks))
        self._raw.clear()
        return out


class _Spans:
    """The innermost logged span at a host time (seconds)."""

    def __init__(self, log):
        self.spans = sorted((t0, t1, label) for label, t0, t1 in log)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, -1, -1):  # the latest-starting span that covers t
            if self.spans[j][1] >= t:
                return self.spans[j][2]
        return "harness"


def _steps(dev, spans: _Spans, marks) -> List[TracedStep]:
    """Split one stretch's device ops (sorted by launch) at the markers."""
    bounds = [i for i, ev in enumerate(dev) if _MARK in ev[3]]
    found = len(bounds) - 1
    if found <= 0:
        return []
    # The surviving steps are the stretch's last ``found`` ones.
    marks = marks[len(marks) - 1 - found:]
    out = []
    for s in range(found):
        lo, hi = bounds[s], bounds[s + 1]
        m0, m1 = dev[lo], dev[hi]
        offset = m0[1] / 1e9 - marks[s][0]   # device clock minus host clock

        def host(ns):
            return spans.at(ns / 1e9 - offset)

        ops = sorted(dev[lo + 1:hi], key=lambda ev: ev[1])
        busy, gaps, cursor = 0, [], m0[1] + m0[2]
        for _, start, dur, _ in ops:
            if start > cursor:
                gaps.append((host((cursor + start) // 2), (start - cursor) / 1e9))
            busy += max(0, start + dur - max(start, cursor))
            cursor = max(cursor, start + dur)
        if m1[1] > cursor:
            gaps.append((host((cursor + m1[1]) // 2), (m1[1] - cursor) / 1e9))
        qmm = collections.Counter(marks[s + 1][1])
        qmm.subtract(marks[s][1])
        out.append(TracedStep(
            t0=marks[s][0], t1=marks[s + 1][0],
            kernels=[(name, dur / 1e9) for _, _, dur, name in dev[lo + 1:hi]],
            busy_s=busy / 1e9, span_s=(m1[1] - m0[1]) / 1e9,
            qmm_calls={k: v for k, v in qmm.items() if v > 0}, gaps=gaps))
    return out


def breakdown(steps: List[TracedStep], top: int = 10) -> dict:
    """The device ops that took most time and the idle time by what the
    host was doing, each [[name, seconds]], most first."""
    ops, idle = collections.Counter(), collections.Counter()
    for st in steps:
        for name, sec in st.kernels:
            ops[name[:120]] += sec
        for label, sec in st.gaps:
            idle[label[:120]] += sec
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
