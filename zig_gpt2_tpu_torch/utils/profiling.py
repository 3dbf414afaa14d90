"""Timing and tracing hooks.

Counterpart of ``zig_gpt2_tpu.utils.profiling``: ``device_timer``, a
wall-clock bracket that waits for its output's device before it reads
the clock, and ``profiler_trace``, a ``torch.profiler`` trace written to a
directory (the JAX package's ``xprof_trace``; the CLI's ``--profile``).

Spans: ``span(name, **attrs)`` brackets a stretch of host work at a layer
boundary of the program (the batcher's admit, decode dispatch, host sync
and bookkeeping; the model's prefill, extend and decode step) and
``record`` keeps one already timed (a request, submit to retirement).
They record only while a ``torch.profiler`` session is active, on any
activities; otherwise a boundary costs one flag check. A record holds its
name, its start and end on ``time.perf_counter()``, the index (in
``spans()``) of the span open when it began, and its attributes. The
records are host-side only: a span emits no profiler range and no device
op, so a trace's device events are the program's alone. They are kept in
memory, in one list per process, up to ``SPAN_CAP``; past it they are
counted as dropped (``dropped_spans``) and not kept.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional

import torch


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


@contextlib.contextmanager
def device_timer(block_on=None) -> Iterator[dict]:
    """Wall-clock bracket. Put the output tensor(s) in ``t["out"]`` (or pass
    existing ones as ``block_on``): before reading the clock the timer
    synchronizes each CUDA device that holds one, since PyTorch returns
    before the card finishes. ``t["ms"]`` holds the time.

    Usage::
        with device_timer() as t:
            t["out"] = fn(x)
        print(t["ms"])
    """
    result: dict = {}
    start = time.perf_counter()
    try:
        yield result
    finally:
        target = result.get("out", block_on)
        for dev in {t.device for t in _tensors(target) if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        result["ms"] = (time.perf_counter() - start) * 1000.0


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str], device="cuda") -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written to
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto), with the card's kernels when ``device`` is a CUDA device;
    a no-op without a directory."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        first = len(_records)
        yield
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "spans.json").write_text(json.dumps(chrome_spans(_records[first:], first)))


# -- spans ----------------------------------------------------------------------

SPAN_CAP = 1 << 16  # records kept per process; later ones are dropped and counted

# True while a torch.profiler session is active, whatever its activities.
recording = torch._C._autograd._profiler_enabled


@dataclass
class Span:
    name: str
    t0: float                   # time.perf_counter() at the start and the end
    t1: float = math.nan        # (nan while open)
    parent: Optional[int] = None  # index in spans() of the span open at the start
    attrs: dict = field(default_factory=dict)


_records: List[Span] = []
_open: List[Optional[int]] = []  # indices of the open spans, innermost last
_dropped = 0


def _keep(rec: Span) -> Optional[int]:
    global _dropped
    if len(_records) >= SPAN_CAP:
        _dropped += 1
        return None
    _records.append(rec)
    return len(_records) - 1


class _Recording:
    __slots__ = ("rec",)

    def __init__(self, name: str, attrs: dict):
        self.rec = Span(name, 0.0, attrs=attrs)

    def __enter__(self) -> dict:
        rec = self.rec
        rec.parent = _open[-1] if _open else None
        _open.append(_keep(rec))
        rec.t0 = time.perf_counter()
        return rec.attrs

    def __exit__(self, *exc) -> bool:
        self.rec.t1 = time.perf_counter()
        _open.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the block as a span while a profiler
    session is active. It yields the record's attribute dict, or None when
    not recording: attributes that cost work to compute are added there,
    only while recording::

        with span("batcher.decode") as a:
            if a is not None:
                a["lanes"] = ...
    """
    if not recording():
        return _OFF
    return _Recording(name, attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Keep a span already timed (``t0``, ``t1`` on ``time.perf_counter()``),
    with no parent, while a profiler session is active."""
    if recording():
        _keep(Span(name, t0, t1, None, attrs))


def spans() -> List[Span]:
    """The records kept, in the order they began (``record``'s at the call)."""
    return list(_records)


def dropped_spans() -> int:
    return _dropped


def clear_spans() -> None:
    """Forget the records and the count of dropped ones (call it with no
    span open)."""
    global _dropped
    _records.clear()
    _dropped = 0


def chrome_spans(records: List[Span], first: int = 0) -> dict:
    """Records as a Chrome trace (``"ph": "X"`` events in microseconds of
    ``time.perf_counter()``); each event's ``args`` hold its attributes and
    ``parent``, its parent's index among ``records`` (``first``: the index
    of ``records[0]`` among all the records kept). A span shares its
    parent's row (``tid``); a span with no parent takes the first row whose
    spans all ended before it began, so that a request, which overlaps the
    steps it spans without nesting in them, takes a row of its own."""
    ends: List[float] = []  # per row, the end of its last span with no parent
    tid, events = [0] * len(records), []
    for i, r in enumerate(records):
        parent = None if r.parent is None or r.parent < first else r.parent - first
        end = r.t1 if math.isfinite(r.t1) else r.t0
        if parent is not None:
            tid[i] = tid[parent]
        else:
            tid[i] = next((n for n, e in enumerate(ends) if r.t0 >= e), len(ends))
            if tid[i] == len(ends):
                ends.append(end)
            ends[tid[i]] = max(ends[tid[i]], end)
        events.append({"name": r.name, "ph": "X", "pid": os.getpid(), "tid": tid[i],
                       "ts": r.t0 * 1e6, "dur": (end - r.t0) * 1e6,
                       "args": {**r.attrs, "parent": parent}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
