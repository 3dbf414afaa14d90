"""Continuous batching: a host-side slot scheduler over one fixed decode batch.

Counterpart of ``zig_gpt2_tpu.runtime.batcher.ContinuousBatcher`` on its
plain decode path. Serving keeps ONE KV cache of B slots alive and streams
requests through the slots:

- ``submit`` queues a request. Free slots are filled in bucket groups: one
  bucketed k-sequence prefill per group (k a power of two, so that a cold
  start of 16 slots costs one or two prefills, not 16), whose rows are
  spliced into the shared cache at the slots' batch indices; each lane's
  first token is sampled straight into the feed vector on the device.
- ``step`` runs ``decode_chunk`` decode + sample sub-steps for the whole
  batch and copies one (chunk, B) int32 token block to the host: the one
  host sync of a step. Stop tokens, budgets, retirement and refill are
  host bookkeeping on that block. On a card without a mesh, each plain
  decode sub-step replays one captured CUDA graph of ``gpt2.decode_step``
  over every lane (``runtime.decode_graph``; ``decode_graph_captures`` and
  ``decode_graph_replays`` in the metrics); the draw after it stays eager.
- A finished slot is refilled from the queue. Until then it keeps decoding
  garbage that the host discards; its next admission resets its rows.

The cache is a ring (``config.ring_cache``) unless ``ZG2_RING=0``, the JAX
package's own switch: every lane's decode row goes to one shared write row
``wptr``, so an append is one indexed write per array, and a lane's rows
are the interval [start, start + length) mod R. An admission writes a
lane's n prefilled rows at ring rows (wptr - n + i) mod R, so that its
interval ends at the write row, and records its start. (The JAX package
rolls the whole lane into place; rows outside an interval are never read.)

The batcher runs on ``device="cuda"`` unless the caller asks for
``device="cpu"``; with no card and no explicit CPU request it raises. Its
cache, and its admissions' lane caches, take the layout that
``gpt2.prepare_serving`` decides at construction, as the engine's. The
sampler draws from a ``torch.Generator`` seeded from ``sampling.seed``.

Prefix caching (``register_prefix``): a registered prefix's rows are kept
as one B=1 linear cache of the slot's rows. Queued prompts that share
leading tokens with one (``engine.match_prefix``) are grouped by prefix
and suffix bucket; a group of k is one (k, bucket) ``gpt2.extend`` over
copies of the stored rows at per-lane bases, spliced in like a prefill.

Speculative serving (``speculative="ngram"``): each step runs
``spec_chunk`` rounds of prompt lookup over each slot's token history and
one (B, spec_k + 1) verify extend (``runtime.speculative``), committing 1
to spec_k + 1 tokens per slot per round, with one host sync per step. Its
cache is linear and unpacked (it sees prefill and extend only). When the
committed tokens per live slot-round over a window of steps fall below
``spec_min_tpr``, the batcher switches to plain decode for good.

Tensor- and data-parallel serving (``mesh=``, a ``parallel.mesh.Mesh``):
every rank runs the same host scheduler over all B slots; data rank d
holds slots [d B/dp, (d + 1) B/dp) in its cache and prefills only the
admissions that land there, and each step's (chunk, B/dp) token block is
gathered over the data group, so that every rank's bookkeeping sees the
same B lanes. Each decode step runs the per-rank model and the
vocab-sharded draw ``sampling.sample_manual``, on a ring or a linear
cache, float or INT8. A registered prefix is stored by every rank (the
rows of its own heads, the same on every data rank), and each data rank
admits the hits that land in its slots. Speculative serving keeps each
slot's history on the data rank that holds the slot; a round's verify
logits are all-gathered over the model group before the acceptance, so
that every rank of the group takes the same accept counts from the same
inputs and one generator kept in step, and the round's (B/dp, ...) block
is gathered over the data group with the step's one host read. The JAX
batcher takes its op-level mesh program there, and so does a rank's
config (``op_level``): after auto-off, a w8a8 decode step quantizes each
row over its whole K. The mesh must live on the batcher's device.

Spans (``utils.profiling.span``, kept only while a ``torch.profiler``
session is active): ``batcher.step`` holds ``batcher.admit`` (with one
``batcher.admit_group`` or ``batcher.admit_prefix`` per admission: its
lanes ``k``, ``bucket``, prompt ``rows``, ``padded`` rows (k x bucket -
rows, on this rank's lanes) and ``rids``; a prefix hit also its reused
``prefix_rows``), ``batcher.decode`` (the chunk's dispatch: live
``lanes``, ``kv_rows_live``, the cache rows that hold their tokens, and
``kv_rows_reserved``, lanes x cache rows), ``batcher.sync`` (the one host
read) and ``batcher.consume`` (the bookkeeping and ``on_token``:
``tokens`` emitted, requests ``retired``). ``batcher.splice`` and every
draw's ``batcher.sample`` sit inside admissions and the decode dispatch,
the model's ``model.*`` spans inside those. A retired request leaves a
``request`` span from its submit to its retirement (``rid``,
``prompt_rows``, ``tokens``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from zig_gpt2_tpu_torch.config import GPTConfig, SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.runtime import decode_graph
from zig_gpt2_tpu_torch.runtime import speculative as spec_mod
from zig_gpt2_tpu_torch.runtime.engine import _bucket, _check_mesh, match_prefix
from zig_gpt2_tpu_torch.runtime.sampling import data_rank_seed, sample, sample_manual
from zig_gpt2_tpu_torch.utils.device import resolve_device
from zig_gpt2_tpu_torch.utils.profiling import record, span
from zig_gpt2_tpu_torch.weights import tree_map


@dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    max_new_tokens: Optional[int]
    stop_tokens: frozenset
    generated: List[int] = field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None  # set while scheduled
    # Speculative serving: True until the slot's first round emits the
    # prefill's token (the plain path emits it as the first one consumed).
    fresh: bool = False
    submitted_at: float = 0.0  # perf_counter at submit (latency metrics)


@dataclass
class BatcherMetrics:
    """Aggregate serving metrics, the JAX batcher's fields."""

    steps: int = 0
    tokens_emitted: int = 0
    prefills: int = 0
    requests_finished: int = 0
    decode_s: float = 0.0          # wall time inside batched decode steps
    prefill_s: float = 0.0         # wall time inside admissions (dispatch)
    occupied_slot_steps: int = 0   # sum of active slots over steps
    prefix_hits: int = 0           # admissions served from the prefix cache
    prefill_tokens_saved: int = 0  # prompt rows not recomputed on those
    spec_rounds: int = 0           # speculative rounds run
    spec_slot_rounds: int = 0      # (live slot, round) pairs consumed
    spec_committed: int = 0        # tokens committed in those pairs
    spec_auto_off_step: Optional[int] = None  # step at which auto-off fired
    sync_ms: List[float] = field(default_factory=list)   # per decode dispatch + sync
    request_latency_s: List[float] = field(default_factory=list)
    decode_graph_captures: int = 0  # CUDA graphs of the decode step captured
    decode_graph_replays: int = 0   # plain decode sub-steps replayed from one

    def slot_utilization(self, batch_size: int) -> float:
        return self.occupied_slot_steps / max(self.steps * batch_size, 1)

    def sync_ms_percentile(self, q: float) -> float:
        """p50/p99 of one decode dispatch + sync: the serving latency
        quantum (a streaming client sees one chunk per sync)."""
        if not self.sync_ms:
            return 0.0
        return float(np.percentile(self.sync_ms, q))

    def request_latency_percentile(self, q: float) -> float:
        """p50/p99 submit-to-finish wall time per request."""
        if not self.request_latency_s:
            return 0.0
        return float(np.percentile(self.request_latency_s, q))

    @property
    def tokens_per_round(self) -> float:
        """Committed tokens per (live slot, round): about 1 when lookup
        never hits, spec_k + 1 at most. Rounds a slot ran through after it
        retired are counted in neither sum."""
        return self.spec_committed / max(self.spec_slot_rounds, 1)

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_emitted / max(self.decode_s, 1e-9)

    def as_dict(self, batch_size: int) -> dict:
        d = {
            "steps": self.steps,
            "tokens_emitted": self.tokens_emitted,
            "prefills": self.prefills,
            "requests_finished": self.requests_finished,
            "decode_s": round(self.decode_s, 4),
            "prefill_s": round(self.prefill_s, 4),
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "slot_utilization": round(self.slot_utilization(batch_size), 4),
        }
        if self.sync_ms:
            d["sync_ms_p50"] = round(self.sync_ms_percentile(50), 3)
            d["sync_ms_p99"] = round(self.sync_ms_percentile(99), 3)
        if self.request_latency_s:
            d["request_s_p50"] = round(self.request_latency_percentile(50), 4)
            d["request_s_p99"] = round(self.request_latency_percentile(99), 4)
        if self.prefix_hits:
            d["prefix_hits"] = self.prefix_hits
            d["prefill_tokens_saved"] = self.prefill_tokens_saved
        if self.spec_rounds:
            d["spec_rounds"] = self.spec_rounds
            d["tokens_per_round"] = round(self.tokens_per_round, 2)
        if self.spec_auto_off_step is not None:
            d["spec_auto_off_step"] = self.spec_auto_off_step
        if self.decode_graph_captures:
            d["decode_graph_captures"] = self.decode_graph_captures
            d["decode_graph_replays"] = self.decode_graph_replays
        return d


class ContinuousBatcher:
    """Streams requests through a fixed batch of KV-cache slots."""

    def __init__(
        self,
        config: GPTConfig,
        params,
        batch_size: int = 8,
        max_seq: Optional[int] = None,
        prompt_buckets: Optional[Sequence[int]] = None,
        sampling: SamplingConfig = SamplingConfig(),
        kv_quant: Optional[str] = None,
        cache_dtype: Optional[torch.dtype] = None,
        on_token: Optional[Callable[[int, int], None]] = None,
        decode_chunk: int = 1,
        mesh=None,
        speculative: Optional[str] = None,
        spec_k: int = 3,
        spec_ngram: int = 2,
        spec_chunk: int = 1,
        spec_min_tpr: float = 1.5,
        device="cuda",
    ):
        """``decode_chunk``: decode steps run on the device per host sync;
        stop and budget checks happen per chunk and a slot that retires
        mid-chunk discards the rest of its chunk. ``kv_quant``: None for a
        float cache in ``cache_dtype`` (default the weights' (wte's) dtype),
        or "int8". ``sampling`` is read at every draw, so a new
        SamplingConfig assigned between ``run`` calls applies to the
        requests admitted after it.

        ``speculative="ngram"``: prompt-lookup speculation, ``spec_k``
        proposals from the last ``spec_ngram`` tokens, ``spec_chunk``
        rounds per host sync (decode_chunk must stay 1). ``spec_min_tpr``:
        the auto-off threshold on windowed tokens per round (0 keeps
        speculation on).

        ``mesh``: serve over a ``parallel.mesh.Mesh``; ``params`` are the
        full weights, batch_size must divide by its dp."""
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown KV quantization {kv_quant!r} (None or 'int8')")
        self._spec = None
        if speculative is not None:
            if speculative != "ngram":
                raise ValueError("serve-mode speculation is draft-free prompt lookup only "
                                 f"(speculative='ngram'), got {speculative!r}")
            if decode_chunk != 1:
                raise ValueError("speculative serving replaces decode_chunk (a round commits "
                                 "up to spec_k + 1 tokens per sync): leave decode_chunk=1")
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            self._spec = (spec_k, max(int(spec_ngram), 1), max(int(spec_chunk), 1))
        self.device = resolve_device(device)
        if mesh is not None:
            _check_mesh(mesh, self.device)
        self.mesh = mesh
        # Speculative serving extends and never decode-steps until auto-off:
        # a linear, unpacked cache.
        self._ring = self._spec is None and os.environ.get("ZG2_RING", "1") != "0"
        config = dataclasses.replace(config, ring_cache=self._ring)
        # This rank's slots: [_first, _first + _lanes) of the batch.
        self._lanes, self._first = batch_size, 0
        if mesh is not None:
            from zig_gpt2_tpu_torch.parallel.mesh import prepare_serving

            self.params, self.config = prepare_serving(params, config, mesh, batch_size,
                                                       self.device)
            if self._spec is not None:  # the JAX op-level program, its cache unpacked
                self.config = dataclasses.replace(self.config, kv_packed=False, op_level=True)
            self._lanes = batch_size // mesh.dp
            self._first = mesh.data_index * self._lanes
        else:
            params = tree_map(lambda t: t.to(self.device), params)
            if self._spec is None:
                self.params, self.config = gpt2.prepare_serving(params, config, self.device)
            else:
                self.params = gpt2.fuse_qkv_if_enabled(params)
                self.config = dataclasses.replace(config, kv_packed=False)
        self.batch_size = batch_size
        self.max_seq = max_seq or config.context_size
        self.sampling = sampling
        self.kv_quant = kv_quant
        self.on_token = on_token  # callback(rid, token) for streaming
        self.decode_chunk = max(int(decode_chunk), 1)
        self.prompt_buckets = tuple(
            b for b in (prompt_buckets or (32, 128, 512, config.context_size))
            if b <= self.max_seq
        ) or (self.max_seq,)
        if self._spec is not None:
            # An active slot can overshoot its budget by spec_chunk rounds'
            # windows before the host sees it, plus extend's k + 1 rows of
            # headroom (idle slots clamp at rows - (k + 1) in the round).
            sk, _, sr = self._spec
            cache_rows = self._hist_cap = self.max_seq + (sr + 1) * (sk + 1)
            self._len_cap = self._hist_len_cap = cache_rows - (sk + 1)
            # Each of this rank's slots' committed tokens, the feed token at
            # _hist_len - 1.
            self._hist = torch.zeros((self._lanes, self._hist_cap), dtype=torch.int32,
                                     device=self.device)
            self._hist_len = torch.zeros((self._lanes,), dtype=torch.int32, device=self.device)
        else:
            # decode_chunk - 1 headroom rows: a slot that hits its budget
            # mid-chunk keeps writing rows until the chunk ends. One more
            # ring row keeps every interval below R, so that none reaches
            # the write row (the longest live interval is max_seq +
            # decode_chunk - 1).
            cache_rows = self.max_seq + self.decode_chunk - 1 + (1 if self._ring else 0)
        self._cache_rows = cache_rows
        self._cache_dtype = cache_dtype or self.params["wte"].dtype
        self.cache = gpt2.init_kv_cache(self.config, self._lanes, cache_rows,
                                        dtype=self._cache_dtype, device=self.device,
                                        quant=kv_quant)
        seed = sampling.seed if mesh is None else data_rank_seed(sampling.seed,
                                                                 mesh.data_index, mesh.dp)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.metrics = BatcherMetrics()
        # Prefix cache: [(token tuple, stored B=1 linear cache)], longest first.
        self._prefixes: List[tuple] = []
        # Speculation auto-off: a window of per-sync (live slot-rounds,
        # committed tokens). After the switch, a slot that ran a round has
        # its feed token already emitted (a round emits what it commits; the
        # plain path emits what it consumes), so its first plain consume
        # drops it (_refeed, cleared on admission).
        self._spec_min_tpr = float(spec_min_tpr)
        self._spec_off = False
        self._tpr_window: Deque[tuple] = deque(maxlen=8)
        self._refeed = [False] * batch_size
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self._next_rid = 0
        # Next feed token per slot, on the device: admissions write into it
        # and each sub-step copies the next one into it, so a step costs one
        # sync and a captured decode step reads it where it lies.
        self._tokens = torch.zeros((self._lanes,), dtype=torch.int32, device=self.device)
        # On a card, plain decode replays one captured CUDA graph; the mesh
        # paths' collectives stay eager.
        self._graph = (decode_graph.DecodeGraph()
                       if decode_graph.usable(self.device, mesh, self.config) else None)

    # -- client API -----------------------------------------------------------

    def submit(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        stop_tokens: Sequence[int] = (),
    ) -> int:
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise ValueError("prompt must contain at least one token")
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(f"prompt length {len(prompt_ids)} >= max_seq {self.max_seq}")
        # Reject here rather than inside _admit mid-run, which would lose
        # every request in flight.
        if len(prompt_ids) > max(self.prompt_buckets):
            raise ValueError(f"prompt length {len(prompt_ids)} exceeds the largest "
                             f"prompt bucket {max(self.prompt_buckets)}")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt_ids, max_new_tokens, frozenset(stop_tokens),
                                  submitted_at=time.perf_counter()))
        return rid

    def register_prefix(self, prefix_ids: Sequence[int]) -> None:
        """Compute and keep the KV rows of a shared prompt prefix (a system
        prompt): later submissions that share leading tokens with it admit
        from the stored rows and compute only their suffix (one extend).
        Memory: one slot's cache per registered prefix (under a mesh, the
        rows of this rank's heads). Output is unchanged."""
        prefix_ids = [int(t) for t in prefix_ids]
        if not prefix_ids:
            raise ValueError("prefix must contain at least one token")
        if len(prefix_ids) > max(self.prompt_buckets):
            raise ValueError(f"prefix length {len(prefix_ids)} exceeds the largest "
                             f"prompt bucket {max(self.prompt_buckets)}")
        n = len(prefix_ids)
        toks = np.zeros((1, _bucket(n, self.prompt_buckets)), np.int32)
        toks[0, :n] = prefix_ids
        init = gpt2.init_kv_cache(self.config, 1, self._cache_rows, dtype=self._cache_dtype,
                                  device=self.device, quant=self.kv_quant, ring=False)
        pre, _ = gpt2.prefill(self.params, init, self._to_device(toks),
                              self._to_device(np.array([n], np.int32)), self.config)
        self._prefixes.append((tuple(prefix_ids), pre))
        self._prefixes.sort(key=lambda t: -len(t[0]))  # the longest match first

    def _match_prefix(self, prompt: List[int]):
        """The longest usable stored-prefix overlap for ``prompt``, or None."""
        return match_prefix(self._prefixes, prompt, self.prompt_buckets, self._cache_rows)

    @property
    def pending(self) -> int:
        return len(self.queue) + sum(r is not None for r in self.slots)

    def step(self) -> Dict[int, List[int]]:
        """Admit queued requests, run one batched decode chunk (or
        ``spec_chunk`` speculative rounds) and return {rid: [tokens]}
        emitted this step."""
        with span("batcher.step"):
            return self._step()

    def _step(self) -> Dict[int, List[int]]:
        with span("batcher.admit"):
            self._admit()
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return {}
        if self._spec is not None and not self._spec_off:
            return self._step_spec(active)
        t0 = time.perf_counter()
        with span("batcher.decode") as a:
            if a is not None:
                a.update(self._kv_rows())
            consumed = [self._tokens.clone()]  # emit the token each sub-step consumes
            for _ in range(self.decode_chunk):
                token = self._sample(self._decode())
                self._tokens.copy_(token)
                consumed.append(token)
            block = torch.stack(consumed[:-1])
            if self.mesh is not None and self.mesh.dp > 1:  # (dp, chunk, B/dp) -> (chunk, B)
                block = self.mesh.data.all_gather(block).permute(1, 0, 2).reshape(
                    self.decode_chunk, -1)
        with span("batcher.sync"):
            block = block.cpu().numpy()  # (chunk, B): the one host sync
        dt = time.perf_counter() - t0
        self.metrics.decode_s += dt
        self.metrics.sync_ms.append(dt * 1000.0)
        self.metrics.steps += self.decode_chunk
        self.metrics.occupied_slot_steps += len(active) * self.decode_chunk

        emitted: Dict[int, List[int]] = {}
        with span("batcher.consume") as a:
            tokens0, retired0 = self.metrics.tokens_emitted, self.metrics.requests_finished
            for i, req in active:
                toks = block[:, i].tolist()
                if self._refeed[i]:  # after auto-off: the feed token was emitted already
                    self._refeed[i] = False
                    toks = toks[1:]
                self._consume(i, req, toks, emitted)
            if a is not None:
                a["tokens"] = self.metrics.tokens_emitted - tokens0
                a["retired"] = self.metrics.requests_finished - retired0
        return emitted

    def _decode(self) -> torch.Tensor:
        """One plain decode sub-step of every lane from the feed vector, the
        cache updated in place: (lanes, vocab) logits. A graph replay on a
        card (``runtime.decode_graph``), else the eager step."""
        if self._graph is None:
            self.cache, logits = gpt2.decode_step(self.params, self.cache, self._tokens,
                                                  self.config)
        else:
            self.cache, logits = self._graph.step(self.params, self.cache, self._tokens,
                                                  self.config, self.metrics)
        return logits

    def _kv_rows(self) -> Dict[str, int]:
        """This rank's live lanes, the cache rows that hold their tokens (a
        live lane's cache holds its prompt and every token it has emitted;
        the next feed token is not yet written) and the rows reserved."""
        live = [r for r in self.slots[self._first:self._first + self._lanes] if r is not None]
        return {"lanes": len(live),
                "kv_rows_live": sum(len(r.prompt_ids) + len(r.generated) for r in live),
                "kv_rows_reserved": self._lanes * self._cache_rows}

    def run(self) -> List[Request]:
        """Drain queue and slots to completion; returns the finished
        requests in completion order."""
        while self.pending:
            self.step()
        done, self.finished = self.finished, []
        return done

    # -- internals -------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        s = self.sampling
        with span("batcher.sample"):
            if self.mesh is not None:
                return sample_manual(logits, self._generator, s.temperature, s.top_k,
                                     s.top_p, self.mesh.model)
            return sample(logits, self._generator, s.temperature, s.top_k, s.top_p)

    def _consume(self, i: int, req: Request, toks: List[int],
                 emitted: Dict[int, List[int]]) -> None:
        """Per-request bookkeeping for a chunk of tokens: a stop token
        retires the request and is not emitted; so do the budget and the
        window. Tokens past a retirement are discarded."""
        for fed in toks:
            if fed in req.stop_tokens:
                self._retire(i, req)
                return
            req.generated.append(fed)
            self.metrics.tokens_emitted += 1
            emitted.setdefault(req.rid, []).append(fed)
            if self.on_token is not None:
                self.on_token(req.rid, fed)
            budget_hit = (req.max_new_tokens is not None
                          and len(req.generated) >= req.max_new_tokens)
            full = len(req.prompt_ids) + len(req.generated) >= self.max_seq
            if budget_hit or full:
                self._retire(i, req)
                return

    def _spec_round(self):
        """One round for the whole batch, with no host sync: proposals from
        each slot's history, the verify extend, then the idle-slot clamps
        (a retired slot keeps verifying garbage: its length keeps extend's
        k + 1 rows of headroom, its history cursor stops at the end; its
        proposals degrade, never its neighbours'). Returns (emit (B, k + 1),
        committed (B,))."""
        sk, sn, _ = self._spec
        s = self.sampling
        ds = spec_mod._propose_ngram(self._hist, self._hist_len, self._tokens, k=sk, ngram=sn)
        self.cache, emit, a, self._tokens = spec_mod._verify_accept_commit(
            self.params, self.config, self.cache, self._tokens, ds, None, self._generator,
            k=sk, greedy=s.temperature == 0.0, temperature=s.temperature, top_k=s.top_k,
            top_p=s.top_p)
        self.cache["length"] = self.cache["length"].clamp(max=self._len_cap)
        spec_mod._write_rows(self._hist, emit, self._hist_len.clamp(max=self._hist_len_cap))
        self._hist_len = (self._hist_len + a + 1).clamp(max=self._hist_len_cap)
        return emit, a + 1

    def _step_spec(self, active) -> Dict[int, List[int]]:
        """One speculative step: ``spec_chunk`` rounds, one host sync. A
        slot's first step also emits the prefill's token (the plain path
        emits it as the first one consumed). Under a mesh the rank's block
        is gathered over the data group first."""
        t0 = time.perf_counter()
        consumed0 = self._tokens
        rounds = [self._spec_round() for _ in range(self._spec[2])]
        # (lanes, 1 + rounds * (k + 2)): the first feed token, then each
        # round's k + 1 emit slots and its count.
        block = torch.cat([consumed0[:, None]] + [t for emit, n in rounds
                                                  for t in (emit, n[:, None])], dim=1)
        if self.mesh is not None and self.mesh.dp > 1:  # (dp, B/dp, w) -> (B, w)
            block = self.mesh.data.all_gather(block).reshape(self.batch_size, -1)
        with span("batcher.sync"):
            host = block.cpu().numpy()  # the one host sync
        consumed0 = host[:, 0]
        per_round = host[:, 1:].reshape(self.batch_size, len(rounds), -1)
        emits, ns = per_round[:, :, :-1], per_round[:, :, -1]  # (B, rounds, k + 1), (B, rounds)
        dt = time.perf_counter() - t0
        self.metrics.decode_s += dt
        self.metrics.sync_ms.append(dt * 1000.0)
        self.metrics.steps += len(rounds)
        self.metrics.occupied_slot_steps += len(active) * len(rounds)
        self.metrics.spec_rounds += len(rounds)

        emitted: Dict[int, List[int]] = {}
        sync_rounds = sync_committed = 0
        for i, req in active:
            if req.fresh:
                req.fresh = False
                self._consume(i, req, [int(consumed0[i])], emitted)
            # Round by round, so that the telemetry counts only rounds the
            # slot was live for (a retired slot's garbage rounds often
            # accept and would inflate tokens_per_round).
            for r in range(len(rounds)):
                if req.done:
                    break
                n = int(ns[i, r])
                self.metrics.spec_slot_rounds += 1
                self.metrics.spec_committed += n
                sync_rounds += 1
                sync_committed += n
                self._consume(i, req, emits[i, r, :n].tolist(), emitted)
        # Auto-off: once the window holds enough evidence, a rate below
        # spec_min_tpr moves the batcher to plain decode for good.
        if self._spec_min_tpr > 0.0 and not self._spec_off:
            self._tpr_window.append((sync_rounds, sync_committed))
            w_rounds = sum(r for r, _ in self._tpr_window)
            if len(self._tpr_window) >= 4 and w_rounds >= 64 and sum(
                    c for _, c in self._tpr_window) < self._spec_min_tpr * w_rounds:
                self._spec_off = True
                self.metrics.spec_auto_off_step = self.metrics.steps
                for i, req in active:
                    # A slot that ran a round has emitted its feed token,
                    # unless it is still fresh or retired just now.
                    if self.slots[i] is req and not req.fresh:
                        self._refeed[i] = True
        return emitted

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the batcher's device. To a card it goes through
        pinned memory without blocking, so an admission adds no host sync."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _admit(self) -> None:
        free = [i for i in range(self.batch_size) if self.slots[i] is None]
        if not free or not self.queue:
            return
        # Pair queued requests with free slots: prefix hits grouped by
        # (prefix, suffix bucket), the others by prompt bucket, so that each
        # group shares one shape.
        by_bucket: Dict[int, List[tuple]] = {}
        by_prefix: Dict[tuple, List[tuple]] = {}
        for i in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            hit = self._match_prefix(req.prompt_ids) if self._prefixes else None
            if hit is not None:
                pidx, usable = hit
                sb = _bucket(len(req.prompt_ids) - usable, self.prompt_buckets)
                by_prefix.setdefault((pidx, sb), []).append((i, req, usable))
                continue
            by_bucket.setdefault(_bucket(len(req.prompt_ids), self.prompt_buckets),
                                 []).append((i, req))
        for (pidx, sb), group in by_prefix.items():
            for chunk in _pow2_chunks(group):
                self._admit_prefix_group(pidx, sb, chunk)
        for bucket, group in by_bucket.items():
            for chunk in _pow2_chunks(group):
                self._admit_group(bucket, chunk)

    def _admit_group(self, bucket: int, group: List[tuple]) -> None:
        """One prefill of k prompts padded to ``bucket`` into a linear k-lane
        cache, its rows spliced into the shared cache at the slots' batch
        indices, and each lane's first token sampled into the feed vector.
        Under a mesh a rank prefills the group's slots it holds."""
        t0 = time.perf_counter()
        k = len(group)
        mine = [(i - self._first, req) for i, req in group
                if self._first <= i < self._first + self._lanes]
        with span("batcher.admit_group") as a:
            if a is not None:
                rows = sum(len(req.prompt_ids) for _, req in mine)
                a.update(k=len(mine), bucket=bucket, rows=rows,
                         padded=len(mine) * bucket - rows, rids=[req.rid for _, req in group])
            if mine:
                toks = np.zeros((len(mine), bucket), np.int32)
                lens = np.zeros((len(mine),), np.int32)
                idxs = np.zeros((len(mine),), np.int64)
                for j, (i, req) in enumerate(mine):
                    toks[j, :len(req.prompt_ids)] = req.prompt_ids
                    lens[j] = len(req.prompt_ids)
                    idxs[j] = i
                toks, lens = self._to_device(toks), self._to_device(lens)
                idxs = self._to_device(idxs)
                lanes = gpt2.init_kv_cache(self.config, len(mine), bucket,
                                           dtype=self.cache["k"].dtype, device=self.device,
                                           quant=self.kv_quant, ring=False)
                lanes, logits = gpt2.prefill(self.params, lanes, toks, lens, self.config)
                self._admit_epilogue(lanes, logits, idxs, toks, lens)
            for i, req in group:
                self._seat(i, req)
        self.metrics.prefills += k
        self.metrics.prefill_s += time.perf_counter() - t0

    def _admit_prefix_group(self, pidx: int, sb: int, group: List[tuple]) -> None:
        """k prefix hits on one stored prefix and one suffix bucket in one
        extend: the stored B=1 rows copied to k lanes at per-lane bases
        (partial overlaps share a group), the (k, sb) suffix windows run,
        the lanes spliced in and each first token sampled from its last
        suffix position. The stored rows are never written."""
        t0 = time.perf_counter()
        k = len(group)
        mine = [(i - self._first, req, usable) for i, req, usable in group
                if self._first <= i < self._first + self._lanes]
        with span("batcher.admit_prefix") as a:
            if a is not None:
                rows = sum(len(req.prompt_ids) - usable for _, req, usable in mine)
                a.update(k=len(mine), bucket=sb, rows=rows, padded=len(mine) * sb - rows,
                         prefix_rows=sum(usable for _, _, usable in mine),
                         rids=[req.rid for _, req, _ in group])
            if mine:
                self._extend_prefix_lanes(self._prefixes[pidx][1], sb, mine)
            for i, req, usable in group:
                self._seat(i, req)
                self.metrics.prefix_hits += 1
                self.metrics.prefill_tokens_saved += usable
        self.metrics.prefills += k
        self.metrics.prefill_s += time.perf_counter() - t0

    def _extend_prefix_lanes(self, pre, sb: int, mine: List[tuple]) -> None:
        """The device half of a prefix admission, on this rank's hits
        (local slot, request, usable rows): the stored rows copied to one
        lane each at its base, the (k, sb) suffix windows extended, the
        lanes spliced in and each first token drawn from its last suffix
        position."""
        k = len(mine)
        toks = np.zeros((k, sb), np.int32)
        bases, slens = np.zeros((k,), np.int32), np.zeros((k,), np.int32)
        idxs = np.zeros((k,), np.int64)
        for j, (i, req, usable) in enumerate(mine):
            suffix = req.prompt_ids[usable:]
            toks[j, :len(suffix)] = suffix
            bases[j], slens[j], idxs[j] = usable, len(suffix), i
        lanes = {name: t.repeat(1, k, *([1] * (t.dim() - 2)))
                 for name, t in pre.items() if name != "length"}
        lanes["length"] = self._to_device(bases)
        slens_d, idxs = self._to_device(slens), self._to_device(idxs)
        lanes, logits = gpt2.extend(self.params, lanes, self._to_device(toks), slens_d,
                                    self.config)
        last = logits[torch.arange(k, device=self.device), slens_d.long() - 1]
        prows = lens = None
        if self._spec is not None:  # the history holds the whole prompt
            prows = np.zeros((k, max(len(r.prompt_ids) for _, r, _ in mine)), np.int32)
            for j, (_, req, _) in enumerate(mine):
                prows[j, :len(req.prompt_ids)] = req.prompt_ids
            prows, lens = self._to_device(prows), lanes["length"]
        self._admit_epilogue(lanes, last, idxs, prows, lens)

    def _admit_epilogue(self, lanes, logits, idxs: torch.Tensor, hist_tokens, hist_lens) -> None:
        """The shared tail of both admissions: splice the k lanes in, sample
        each first token into the feed vector and, when speculating, seed
        each slot's history with [prompt..., first] (``hist_tokens`` (k, T)
        right-padded, ``hist_lens`` (k,))."""
        with span("batcher.splice"):
            self._splice(lanes, idxs, lanes["length"])
        first = self._sample(logits)
        self._tokens[idxs] = first
        if self._spec is None:
            return
        rows = torch.zeros((len(first), self._hist_cap), dtype=torch.int32, device=self.device)
        rows[:, :hist_tokens.shape[1]] = hist_tokens
        rows.scatter_(1, hist_lens.long()[:, None], first[:, None])
        self._hist[idxs] = rows
        self._hist_len[idxs] = hist_lens + 1

    def _seat(self, i: int, req: Request) -> None:
        req.slot = i
        req.fresh = self._spec is not None
        self._refeed[i] = False
        self.slots[i] = req

    def _splice(self, lanes, idxs: torch.Tensor, lens: torch.Tensor) -> None:
        """Write the k lanes' rows [0, T) into the shared cache at batch
        indices ``idxs`` (T up to the shared cache's rows: a prefill's
        bucket, or a prefix lane's whole slot): at rows [0, T) of a linear
        cache, or at ring rows (start + i) mod R with start = (wptr - n) mod
        R, so that each lane's n valid rows end at the write row. One indexed
        write per array, on the S axis (axis 3) of either layout; rows i >= n
        are padding that no read reaches."""
        R = self.cache["k"].shape[-2]
        T = lanes["k"].shape[-2]
        rows = torch.arange(T, device=self.device)[None, :]
        if self._ring:
            start = (self.cache["wptr"] - lens) % R
            self.cache["start"][idxs] = start
            rows = (start[:, None] + rows) % R
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in lanes:
                src = lanes[name]  # (L, k, H, T[, D]) or (L, k, Hp, T[, 2D]): (k, T) first
                self.cache[name][:, idxs[:, None], :, rows] = src.permute(
                    1, 3, 0, 2, *range(4, src.dim()))
        self.cache["length"][idxs] = lens

    def _retire(self, slot: int, req: Request) -> None:
        # No device work: the idle slot keeps decoding garbage that the host
        # discards, and the next admission's splice resets its rows.
        req.done = True
        req.slot = None
        self.slots[slot] = None
        self.metrics.requests_finished += 1
        if req.submitted_at:
            now = time.perf_counter()
            self.metrics.request_latency_s.append(now - req.submitted_at)
            record("request", req.submitted_at, now, rid=req.rid,
                   prompt_rows=len(req.prompt_ids), tokens=len(req.generated))
        self.finished.append(req)


def _pow2_chunks(group: List[tuple]):
    """A group split into power-of-two chunks, the biggest first (one
    admission shape per chunk size)."""
    start = 0
    while start < len(group):
        k = 1 << ((len(group) - start).bit_length() - 1)
        yield group[start:start + k]
        start += k
