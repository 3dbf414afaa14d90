"""Drive the program through one cell: build it, warm it, serve a closed loop
and measure a window.

The system under test is the program's ``ContinuousBatcher``, as the
configuration's model family builds it (``build`` in
``portbench/families/<model_type>/program.py``) from the weights the family
draws from the seed. As many clients as the mix names each keep one
request outstanding: the harness submits a client's next request as soon
as its last one retires, and takes each token's arrival time from the
batcher's ``on_token`` callback.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.spec import family
from portbench.traffic import Request, Traffic


@dataclass
class Served:
    req: Request
    submitted: float
    float_rows: int               # prompt rows the first token's pass read unquantized
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    finished: Optional[float] = None


@dataclass
class Window:
    """What the per-layer readers read (``portbench/metrics/*.py``)."""
    config: dict
    batch: int
    seconds: float
    counters: Dict[str, float]    # the program's BatcherMetrics, over the window
    sync_ms: List[float]          # the program's per-step dispatch + sync times
    prompt_tokens: int            # prompt tokens admitted in the window (prefixes too)
    flops: float                  # model FLOPs of every token processed in it
    steps: list = field(default_factory=list)    # trace.TracedStep, traced runs only
    step_tokens: list = field(default_factory=list)  # per traced step: old rows per token
    end_to_end: Dict[str, float] = field(default_factory=dict)  # the window's, as measured


def build(config: dict, traffic: Traffic, seed: int, device, on_token):
    """The program, from the seed's weights, as the configuration's family
    builds it."""
    from zig_gpt2_tpu_torch.config import SamplingConfig

    fam = family(config)
    sampling = SamplingConfig(temperature=traffic.temperature, seed=seed & (2 ** 63 - 1))
    # The weights are the callee's alone, so a quantized copy can free them.
    return fam.program.build(config, fam.model.make_weights(config, seed, device), traffic,
                             sampling, device, on_token)


class Loop:
    """The closed loop over one batcher."""

    def __init__(self, traffic: Traffic):
        self.traffic = traffic
        self.batcher = None
        self.live: Dict[int, Served] = {}
        self.done: List[Served] = []
        self.next = 0
        self.tracer = None

    def on_token(self, rid: int, token: int) -> None:
        rec = self.live.get(rid)
        if rec is not None:
            rec.times.append(time.perf_counter())
            rec.tokens.append(int(token))

    def submit(self) -> None:
        req = self.traffic.request(self.next)
        self.next += 1
        float_rows = min(req.shared, len(req.prompt) - 1) if req.shared else len(req.prompt)
        rid = self.batcher.submit(req.prompt, req.budget)
        self.live[rid] = Served(req, time.perf_counter(), float_rows)

    def step(self) -> None:
        if self.tracer is not None:
            self.tracer.span("portbench.step", self.batcher.step)
        else:
            self.batcher.step()
        finished, self.batcher.finished = self.batcher.finished, []
        now = time.perf_counter()
        for r in finished:
            rec = self.live.pop(r.rid, None)
            if rec is not None:  # a warm-up request has none and no successor
                rec.finished = now
                self.done.append(rec)
                self.submit()


def bucket_of(n: int, buckets) -> int:
    return min(b for b in buckets if n <= b)


def warm(loop: Loop, sync) -> None:
    """Every admission shape the mix can ask for, once: for each prompt
    bucket its lengths reach and each power-of-two group up to the batch,
    one admission of that many requests of one token each (they retire at
    once). With a shared prefix the groups are prefix hits, as the mix's.
    Eager PyTorch compiles nothing per shape, but a shape's first run loads
    its kernels (CUDA's lazy module loading), has cuBLAS pick an algorithm
    and grows the allocator's pools: a burst of retirements in the window
    may admit any of these groups."""
    b, t = loop.batcher, loop.traffic
    lengths = t.prompt_lengths()
    for bucket in sorted({bucket_of(int(n), b.prompt_buckets) for n in lengths}):
        n = int(max(x for x in lengths if bucket_of(int(x), b.prompt_buckets) == bucket))
        k = 1
        while k <= t.batch:
            for _ in range(k):
                b.submit(t.prefix + [0] * n, 1)
            b.step()
            b.finished = []
            k *= 2
    sync()


@contextlib.contextmanager
def quiet_collector():
    """Python's cyclic collector off for the window: its full passes over
    the set-up's objects would land inside steps and in the latency tails.
    What set-up made is frozen out of later passes; the window's garbage
    is collected once it has closed."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
        gc.collect()


def counters(metrics) -> Dict[str, float]:
    return {"steps": metrics.steps, "occupied_slot_steps": metrics.occupied_slot_steps,
            "prefill_s": metrics.prefill_s, "prefix_hits": metrics.prefix_hits,
            "prefill_tokens_saved": metrics.prefill_tokens_saved,
            "sync_count": len(metrics.sync_ms)}


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    window: Window
    done: List[Served]
    attempted: int
    memory_peak_bytes: int


def serve(config: dict, traffic: Traffic, seed: int, seconds: float, device, t_start: float,
          tracer=None) -> Outcome:
    """Build, warm, run the closed loop, measure ``seconds``; the program's
    state is freed before this returns."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    loop = Loop(traffic)
    batcher = build(config, traffic, seed, dev, loop.on_token)
    loop.batcher = batcher
    if traffic.prefix:
        batcher.register_prefix(traffic.prefix)
    warm(loop, sync)
    for _ in range(traffic.clients):
        loop.submit()
    for _ in range(traffic.warm_steps):
        loop.step()
    sync()

    from zig_gpt2_tpu_torch.quant.kernels import qmm

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)  # the window's peak, not the warm-up's
    with quiet_collector():
        loop.tracer = tracer
        before = counters(batcher.metrics)
        submitted0 = loop.next
        t_open = time.perf_counter()
        while (now := time.perf_counter()) - t_open < seconds:
            if tracer is not None and tracer.due(now - t_open):
                tracer.stretch(loop.step, lambda: qmm.by_shape)
            else:
                loop.step()
        t_close = time.perf_counter()
        loop.tracer = None
    after = counters(batcher.metrics)
    sync_ms = list(batcher.metrics.sync_ms[int(before["sync_count"]):])
    attempted = loop.next - submitted0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    steps = tracer.reduce() if tracer is not None else []
    records = list(loop.live.values()) + loop.done
    del batcher, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    window = t_close - t_open
    end_to_end, prompt_tokens, flops = measure(config, records, t_open, t_close)
    end_to_end["setup_s"] = t_open - t_start
    w = Window(config, traffic.batch, window,
               {k: after[k] - before[k] for k in after}, sync_ms, prompt_tokens, flops,
               steps, [old_rows(records, st.t0, st.t1) for st in steps], dict(end_to_end))
    done = [r for r in records if r.finished is not None and r.finished <= t_close]
    return Outcome(end_to_end, w, done, attempted, peak)


def measure(config: dict, records: List[Served], t_open: float, t_close: float):
    """The end-to-end metrics over the window, from the clients' side, and
    the prompt tokens and model FLOPs the window processed."""
    model = family(config).model
    tokens, ttft, itl = 0, [], []
    prompt_tokens, flops = 0, 0.0
    for r in records:
        n = len(r.req.prompt)
        inside = [i for i, t in enumerate(r.times) if t_open <= t <= t_close]
        tokens += len(inside)
        for i in inside:
            if i == 0:
                ttft.append((r.times[0] - r.submitted) * 1e3)
                prompt_tokens += n
                start = r.float_rows if r.req.shared else 0
                flops += model.prompt_flops(config, start, n)
            elif r.times[i - 1] >= t_open:
                itl.append((r.times[i] - r.times[i - 1]) * 1e3)
            # the decode step that fed this token attended n + i rows and itself
            flops += model.token_flops(config, n + i + 1)
    e2e = {"tokens_per_s": tokens / (t_close - t_open),
           "ttft_ms_p95": float(np.percentile(ttft, 95)) if ttft else math.nan,
           "itl_ms_p95": float(np.percentile(itl, 95)) if itl else math.nan,
           "itl_ms_p10": float(np.percentile(itl, 10)) if itl else math.nan}
    return e2e, prompt_tokens, flops


def old_rows(records: List[Served], t0: float, t1: float) -> List[int]:
    """Cached rows each lane's decode read in the step [t0, t1]: one entry
    per token delivered then."""
    rows = []
    for r in records:
        lo, hi = bisect.bisect_left(r.times, t0), bisect.bisect_right(r.times, t1)
        rows.extend(len(r.req.prompt) + i for i in range(lo, hi))
    return rows
