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
  host bookkeeping on that block.
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
Prefix caching (``register_prefix``), speculative serving
(``speculative=``) and a device mesh (``mesh=``) are not in the port yet.
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
from zig_gpt2_tpu_torch.runtime.engine import _bucket, _resolve_device
from zig_gpt2_tpu_torch.runtime.sampling import sample
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
    submitted_at: float = 0.0  # perf_counter at submit (latency metrics)


@dataclass
class BatcherMetrics:
    """Aggregate serving metrics, the JAX batcher's fields. The prefix and
    speculation counters stay zero until those slices are ported."""

    steps: int = 0
    tokens_emitted: int = 0
    prefills: int = 0
    requests_finished: int = 0
    decode_s: float = 0.0          # wall time inside batched decode steps
    prefill_s: float = 0.0         # wall time inside admissions (dispatch)
    occupied_slot_steps: int = 0   # sum of active slots over steps
    prefix_hits: int = 0
    prefill_tokens_saved: int = 0
    spec_rounds: int = 0
    spec_slot_rounds: int = 0
    spec_committed: int = 0
    spec_auto_off_step: Optional[int] = None
    sync_ms: List[float] = field(default_factory=list)   # per decode dispatch + sync
    request_latency_s: List[float] = field(default_factory=list)

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
        on_token: Optional[Callable[[int, int], None]] = None,
        decode_chunk: int = 1,
        mesh=None,
        speculative: Optional[str] = None,
        device="cuda",
    ):
        """``decode_chunk``: decode steps run on the device per host sync;
        stop and budget checks happen per chunk and a slot that retires
        mid-chunk discards the rest of its chunk. ``kv_quant``: None for a
        float cache in the weights' (wte's) dtype, or "int8". ``sampling``
        is read at every draw, so a new SamplingConfig assigned between
        ``run`` calls applies to the requests admitted after it."""
        if speculative is not None:
            raise NotImplementedError("speculative serving needs gpt2.extend, which "
                                      "comes with the extend/speculation slice")
        if mesh is not None:
            raise NotImplementedError("serving on a device mesh comes with the "
                                      "multi-GPU slice")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown KV quantization {kv_quant!r} (None or 'int8')")
        self.device = _resolve_device(device)
        self._ring = os.environ.get("ZG2_RING", "1") != "0"
        self.params, self.config = gpt2.prepare_serving(
            tree_map(lambda t: t.to(self.device), params),
            dataclasses.replace(config, ring_cache=self._ring), self.device)
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
        # decode_chunk - 1 headroom rows: a slot that hits its budget
        # mid-chunk keeps writing rows until the chunk ends. One more ring
        # row keeps every interval below R, so that none reaches the write
        # row (the longest live interval is max_seq + decode_chunk - 1).
        cache_rows = self.max_seq + self.decode_chunk - 1 + (1 if self._ring else 0)
        self.cache = gpt2.init_kv_cache(self.config, batch_size, cache_rows,
                                        dtype=self.params["wte"].dtype,
                                        device=self.device, quant=kv_quant)
        self._generator = torch.Generator(device=self.device).manual_seed(sampling.seed)
        self.metrics = BatcherMetrics()
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: Deque[Request] = deque()
        self.finished: List[Request] = []
        self._next_rid = 0
        # Next feed token per slot, on the device: admissions write into it
        # and each chunk returns the next one, so a step costs one sync.
        self._tokens = torch.zeros((batch_size,), dtype=torch.int32, device=self.device)

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
        raise NotImplementedError("prefix caching needs gpt2.extend, which comes "
                                  "with the extend/speculation slice")

    @property
    def pending(self) -> int:
        return len(self.queue) + sum(r is not None for r in self.slots)

    def step(self) -> Dict[int, List[int]]:
        """Admit queued requests, run one batched decode chunk and return
        {rid: [tokens]} emitted this step."""
        self._admit()
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return {}
        t0 = time.perf_counter()
        consumed = []
        token = self._tokens
        for _ in range(self.decode_chunk):
            consumed.append(token)  # emit the token each sub-step consumes
            self.cache, logits = gpt2.decode_step(self.params, self.cache, token,
                                                  self.config)
            token = self._sample(logits)
        self._tokens = token
        block = torch.stack(consumed).cpu().numpy()  # (chunk, B): the one host sync
        dt = time.perf_counter() - t0
        self.metrics.decode_s += dt
        self.metrics.sync_ms.append(dt * 1000.0)
        self.metrics.steps += self.decode_chunk
        self.metrics.occupied_slot_steps += len(active) * self.decode_chunk

        emitted: Dict[int, List[int]] = {}
        for i, req in active:
            self._consume(i, req, block[:, i].tolist(), emitted)
        return emitted

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
        # Pair queued requests with free slots, grouped by prompt bucket so
        # that each group shares one prefill shape.
        by_bucket: Dict[int, List[tuple]] = {}
        for i in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            by_bucket.setdefault(_bucket(len(req.prompt_ids), self.prompt_buckets),
                                 []).append((i, req))
        for bucket, group in by_bucket.items():
            start = 0
            while start < len(group):  # power-of-two groups, biggest first
                k = 1 << ((len(group) - start).bit_length() - 1)
                self._admit_group(bucket, group[start:start + k])
                start += k

    def _admit_group(self, bucket: int, group: List[tuple]) -> None:
        """One prefill of k prompts padded to ``bucket`` into a linear k-lane
        cache, its rows spliced into the shared cache at the slots' batch
        indices, and each lane's first token sampled into the feed vector."""
        t0 = time.perf_counter()
        k = len(group)
        toks = np.zeros((k, bucket), np.int32)
        lens = np.zeros((k,), np.int32)
        idxs = np.zeros((k,), np.int64)
        for j, (i, req) in enumerate(group):
            toks[j, :len(req.prompt_ids)] = req.prompt_ids
            lens[j] = len(req.prompt_ids)
            idxs[j] = i
        toks, lens, idxs = self._to_device(toks), self._to_device(lens), self._to_device(idxs)
        lanes = gpt2.init_kv_cache(self.config, k, bucket, dtype=self.cache["k"].dtype,
                                   device=self.device, quant=self.kv_quant, ring=False)
        lanes, logits = gpt2.prefill(self.params, lanes, toks, lens, self.config)
        self._splice(lanes, idxs, lens)
        self._tokens[idxs] = self._sample(logits)
        for i, req in group:
            req.slot = i
            self.slots[i] = req
        self.metrics.prefills += k
        self.metrics.prefill_s += time.perf_counter() - t0

    def _splice(self, lanes, idxs: torch.Tensor, lens: torch.Tensor) -> None:
        """Write the k prefilled lanes' rows [0, T) into the shared cache at
        batch indices ``idxs``: at rows [0, T) of a linear cache, or at ring
        rows (start + i) mod R with start = (wptr - n) mod R, so that each
        lane's n valid rows end at the write row. One indexed write per
        array, on the S axis (axis 3) of either layout; rows i >= n are
        padding that no read reaches."""
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
            self.metrics.request_latency_s.append(time.perf_counter() - req.submitted_at)
        self.finished.append(req)
