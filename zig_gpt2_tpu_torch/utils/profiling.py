"""Timing and tracing hooks.

Counterpart of ``zig_gpt2_tpu.utils.profiling``: ``device_timer``, a
wall-clock bracket that waits for its output's device before it reads
the clock, and ``profiler_trace``, a ``torch.profiler`` trace written to a
directory (the JAX package's ``xprof_trace``; the CLI's ``--profile``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

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
        yield
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
