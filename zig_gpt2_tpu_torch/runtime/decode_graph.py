"""The batcher's plain decode step, replayed from one CUDA graph.

A decode step of GPT-2 1.5B issues about 4,500 kernel launches (124M about
640), each dispatched eagerly from Python, and on a card the host's
dispatch, not the device, sets the step's time. ``DecodeGraph`` captures
one ``gpt2.decode_step`` over all of a batcher's lanes into a
``torch.cuda.CUDAGraph`` once and replays it for every plain decode
sub-step: the same kernels, with the same geometry, in the same order, on
the same dtypes, from one launch.

- Fixed addresses. The graph reads the parameters, the cache's tensors
  (``decode_step`` updates ``length`` and ``wptr`` in place) and the
  batcher's one feed vector of tokens (admissions write into it, and the
  sampled token is copied into it), and writes its logits to one static
  output. It is keyed on what it reads: the params tree, the data pointers
  of the cache's tensors and of the feed vector, the lane count, and the
  switches the step reads at each call (``ZG2_WMM``, ``ZG2_QMM``). Where
  any of them changed (the speculative batcher rebinds the cache's length
  before auto-off hands over to plain decode) it is captured again.
- Capture. First an eager warm-up call on a side stream, which loads each
  kernel, has cuBLAS set up that stream's workspace and grows the
  allocator's pools. Its effects are undone: the K/V rows it wrote lie
  outside every lane's interval and the replay writes them again, and
  ``length`` and ``wptr`` are copied back. Then the capture, which runs no
  kernel, and this step's replay. A step that rebinds its cache's tensors
  instead of updating them in place (as the benchmark's planted ``stale``
  fault does) cannot be replayed: its warm-up call is kept as the step, the
  rebound cache is returned, and that ``DecodeGraph`` stays eager, with a
  warning logged once.
- Launch tallies. A replay calls no kernel wrapper, so it would leave the
  wrappers' counts (``ops.tallies``: ``qmm.by_shape``, ``wmm.by_shape``,
  the attention wrappers' ``launches`` and ``by_dtype``, ...) behind the
  eager path's. The capture's own count is one step's; it is taken back
  out with the warm-up's, since the capture runs no kernel and the
  warm-up's result is thrown away, and added on every replay. After any
  sequence of steps every tally equals what the eager path would have
  counted.
- Where. The batcher's choice (``usable``) rests on what it can observe: a
  CUDA device, and neither a mesh nor a model group (gloo's collectives are
  staged through the host and cannot be captured). The sampler stays eager
  after the replay, so no RNG state enters the graph.

A replay runs inside a ``model.decode_step`` span with ``graph`` 1, as the
eager step's span carries ``graph`` 0.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.ops import tallies
from zig_gpt2_tpu_torch.quant import quantize
from zig_gpt2_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)


def usable(device: torch.device, mesh, config) -> bool:
    """Whether a batcher on ``device`` replays its decode step from a graph:
    on a CUDA card without a mesh or a model group."""
    return device.type == "cuda" and mesh is None and config.model_group is None


def graph_key(params, cache, tokens: torch.Tensor) -> tuple:
    """What a captured step reads, by identity: the params tree, the feed
    vector's address and lane count, the switches ``decode_step`` reads at
    each call (``ZG2_WMM``, ``ZG2_QMM``), and each cache tensor's address."""
    return (id(params), tokens.data_ptr(), tokens.shape[0], gpt2._use_wmm(),
            quantize._use_qmm(), tuple((name, t.data_ptr()) for name, t in cache.items()))


class DecodeGraph:
    """One captured plain ``gpt2.decode_step`` over a batcher's lanes."""

    def __init__(self):
        self.eager = False          # set by a step that rebinds its cache
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._key = None
        self._held = None           # what the graph reads, alive while it may replay
        self._logits: Optional[torch.Tensor] = None
        self._delta: dict = {}

    def step(self, params, cache, tokens: torch.Tensor, config, metrics):
        """One decode step of every lane of ``cache`` from the feed vector
        ``tokens`` (read where it lies): (cache, (B, vocab) logits), as
        ``gpt2.decode_step`` returns them. On a replay the cache is the one
        given, updated in place, and the logits the graph's static output,
        valid until the next step. Counts ``metrics.decode_graph_captures``
        and ``decode_graph_replays``."""
        if self.eager:
            return gpt2.decode_step(params, cache, tokens, config)
        key = graph_key(params, cache, tokens)
        if key != self._key:
            stepped = self._capture(params, cache, tokens, config)
            if stepped is not None:
                return stepped
            self._key = key
            metrics.decode_graph_captures += 1
        with span("model.decode_step", B=tokens.shape[0], T=1, graph=1):
            self._graph.replay()
        tallies.add(self._delta)
        metrics.decode_graph_replays += 1
        return cache, self._logits

    def _capture(self, params, cache, tokens, config):
        """Warm up, undo the warm-up, capture. Returns None, or where the
        step rebinds its cache the warm-up's (cache, logits) (this object
        then stays eager)."""
        self._graph = self._logits = self._held = self._key = None  # free the old pool
        held = dict(cache)
        counters = [cache[name] for name in ("length", "wptr") if name in cache]
        saved = [t.clone() for t in counters]
        before = tallies.snapshot()
        main = torch.cuda.current_stream(tokens.device)
        side = torch.cuda.Stream(tokens.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out, logits = gpt2.decode_step(params, cache, tokens, config)
        main.wait_stream(side)
        if out is not cache or out.keys() != held.keys() or any(
                out[name] is not t for name, t in held.items()):
            self.eager = True
            log.warning("the decode step rebinds its cache's tensors instead of updating "
                        "them in place: this batcher's decode runs eagerly, without a CUDA graph")
            return out, logits
        for t, s in zip(counters, saved):
            t.copy_(s)
        warm = tallies.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            _, self._logits = gpt2.decode_step(params, cache, tokens, config)
        done = tallies.snapshot()
        self._delta = tallies.delta(warm, done)
        tallies.add(tallies.delta(before, done), -1)
        self._graph, self._held = graph, (params, held, tokens)
        return None
