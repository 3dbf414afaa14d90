"""Speculative decoding: a draft proposes k tokens per round, the target
verifies them in one (k + 1)-row ``gpt2.extend`` window and keeps the
longest accepted prefix plus one token of its own.

Counterpart of ``zig_gpt2_tpu.runtime.speculative``. The emitted stream
follows the target's law: greedy rounds reproduce the target's greedy
tokens, and sampled rounds take the accept / residual-resample rule
(Leviathan et al. 2023; Chen et al. 2023), under which every emitted
token is distributed as the target's (top-k / top-p masks applied to both
sides). The draft is a small model, or prompt lookup (``draft_config``
None: continue the latest earlier occurrence of the last ``ngram``
committed tokens, a one-hot draft for the rule).

A round, per lane:
- both caches hold the M processed tokens; ``tok`` is committed and not
  yet processed. The draft may be one token further behind (``pend``,
  ``pv``: the previous round accepted all k drafts, so d_k never went
  through the draft): one 2-row extend catches it up (1 or 2 valid rows)
  and gives the first proposal, then k - 1 ``decode_step``s the rest;
- the target extends [tok, d_1..d_k] once, accepts the longest prefix
  (greedy: argmax equals the draft; sampled: u * q(d) < p(d)) and takes
  the next token from the residual max(P - Q, 0), or from P_{k+1} when
  all k are accepted (Q padded with a zero row makes both one gather);
- both lengths rewind to M + 1 + a: rows past them are garbage that the
  next round's appends overwrite.

The draws of a round (draft samples, acceptance uniforms, residual draws)
and the first token come from one explicit ``torch.Generator`` seeded from
``sampling.seed``, as Gumbel-max over the scaled logits; the JAX package
draws them with ``jax.random``, not with its sampler kernel, so sampled
tokens match it in distribution only. Greedy tokens match bit for bit on
the CPU. The round loop runs eagerly on the device with one host read per
round (whether every lane has its tokens; the streaming path's tokens).

``SpeculativeEngine`` is single-device, as the JAX package's is (its
scope): a rank's config is refused. The target's cache is
unpacked (it only ever sees ``extend``); the draft's is packed only under
``ZG2_SPEC_DRAFT_PACKED=1`` where ``gpt2.default_kv_packed`` allows it, its
odd head count then padded with the phantom head. The target's side of a
round (``_verify_accept_commit``) also serves the batcher's prompt lookup
over a mesh: on a rank's config it all-gathers the verify logits over the
model group first, so that every rank of the group decides from the same
full-vocab distributions.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from zig_gpt2_tpu_torch.config import GPTConfig, SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.ops.layers import divide
from zig_gpt2_tpu_torch.runtime.engine import (GenerationMetrics, StreamDecoder, _bucket,
                                               _drain_stream)
from zig_gpt2_tpu_torch.runtime.sampling import _mask_logits
from zig_gpt2_tpu_torch.utils.device import resolve_device
from zig_gpt2_tpu_torch.weights import tree_map


def _single_device_config(config: GPTConfig, extend_only: bool, device) -> GPTConfig:
    """The cache layout of one model of the engine: the target's
    (``extend_only``) always unpacked; the draft's packed only under
    ``ZG2_SPEC_DRAFT_PACKED=1`` and where ``default_kv_packed`` allows it.
    A rank's config (``model_group``) raises ValueError: single-device."""
    if config.model_group is not None:
        raise ValueError("SpeculativeEngine is single-device, as the JAX package's: pass "
                         "unsharded params and configs (prompt lookup serves under a mesh "
                         "through ContinuousBatcher(speculative='ngram'))")
    want = False
    if not extend_only and os.environ.get("ZG2_SPEC_DRAFT_PACKED") == "1":
        want = gpt2.default_kv_packed(dataclasses.replace(config, kv_packed=False), device)
    return dataclasses.replace(config, kv_packed=want)


def _scaled(logits: torch.Tensor, temperature: float, top_k: Optional[int],
            top_p: Optional[float]) -> torch.Tensor:
    """Temperature-scaled logits with the top-k / nucleus mask: the sampling
    law on both sides of the acceptance test."""
    return _mask_logits(divide(logits.float(), temperature), top_k, top_p)


def _probs(logits: torch.Tensor, temperature: float, top_k: Optional[int] = None,
           top_p: Optional[float] = None) -> torch.Tensor:
    return torch.softmax(_scaled(logits, temperature, top_k, top_p), dim=-1)


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of (..., V) logits (-inf excluded), Gumbel-max with
    uniforms from ``generator``: (...,) int32."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def _propose_ngram(hist: torch.Tensor, hist_len: torch.Tensor, tok: torch.Tensor, *,
                   k: int, ngram: int) -> torch.Tensor:
    """Prompt-lookup proposals (B, k): continue the latest earlier
    occurrence of the last ``ngram`` committed tokens, cyclically with the
    match's period (exact for a repetition loop). hist[:, :L] holds every
    committed token, the unprocessed ``tok`` at L - 1; a lane without a
    match, or with fewer than ngram + 1 tokens, proposes ``tok`` k times."""
    B, C = hist.shape
    pos = torch.arange(C, device=hist.device)[None, :]
    match = torch.ones((B, C), dtype=torch.bool, device=hist.device)
    for o in range(ngram):
        # A negative index only occurs where hist_len <= ngram, masked below.
        tail = hist.gather(1, (hist_len - 1 - o).clamp(min=0)[:, None].long())
        match &= torch.roll(hist, o, dims=1) == tail  # hist[j - o] at column j
    match &= (pos >= ngram - 1) & (pos <= (hist_len - 2)[:, None])
    match &= (hist_len > ngram)[:, None]
    j = torch.where(match, pos, -1).amax(1)
    p = ((hist_len - 1) - j).clamp(min=1)
    offs = torch.arange(k, device=hist.device)[None, :] % p[:, None]
    props = hist.gather(1, (j[:, None] + 1 + offs).clamp(max=C - 1).long())
    return torch.where((j >= 0)[:, None], props, tok[:, None].expand(B, k))


def _verify_accept_commit(params_t, conf_t: GPTConfig, cache_t, tok: torch.Tensor,
                          ds: torch.Tensor, Q: Optional[torch.Tensor],
                          generator: Optional[torch.Generator], *, k: int, greedy: bool,
                          temperature: float, top_k, top_p):
    """The target's side of a round, shared with the batcher's speculative
    serving: one (k + 1)-row verify extend over [tok, d_1..d_k], the
    longest accepted prefix a, and the next token. ``Q``: the draft's
    (B, k, V) distributions, or None for a deterministic proposal (one-hot).
    Returns (cache_t, emit (B, k + 1), a (B,), nxt (B,)): emit holds
    d_1..d_a then nxt at slot a, zeros after; the cache's length is rewound
    to base + 1 + a. On a rank's config (``model_group``) the extend's
    vocab slice is all-gathered over the group first: every rank of it
    then decides from the same inputs (its ``generator`` kept in step with
    theirs) and commits the same tokens."""
    B = tok.shape[0]
    m_t = cache_t["length"]
    window = torch.cat([tok[:, None], ds], dim=1)
    cache_t, lt = gpt2.extend(params_t, cache_t, window,
                              torch.full((B,), k + 1, dtype=torch.int32, device=tok.device),
                              conf_t)
    if conf_t.model_group is not None:
        lt = conf_t.model_group.all_gather_cat(lt, dim=-1)
    if greedy:
        tgt = torch.argmax(lt, dim=-1).to(torch.int32)  # (B, k + 1)
        acc = tgt[:, :k] == ds
    else:
        P = _probs(lt, temperature, top_k, top_p)  # (B, k + 1, V)
        if Q is None:  # a deterministic proposal: a one-hot draft law
            Q = torch.nn.functional.one_hot(ds.long(), P.shape[-1]).to(P.dtype)
        p_tok = P[:, :k].gather(2, ds[:, :, None].long())[..., 0]
        q_tok = Q.gather(2, ds[:, :, None].long())[..., 0]
        u = torch.rand((B, k), generator=generator, device=tok.device)
        acc = u * q_tok < p_tok
    a = torch.cumprod(acc.to(torch.int32), dim=1).sum(1).to(torch.int32)
    if greedy:
        nxt = tgt.gather(1, a[:, None].long())[:, 0]
    else:
        # The residual and the bonus in one: Q padded with a zero row at k.
        Qp = torch.cat([Q, torch.zeros_like(P[:, :1])], dim=1)
        at = a[:, None, None].long().expand(B, 1, P.shape[-1])
        P_a, Q_a = P.gather(1, at)[:, 0], Qp.gather(1, at)[:, 0]
        resid = (P_a - Q_a).clamp(min=0.0)
        norm = resid.sum(-1, keepdim=True)
        resid = torch.where(norm > 0, resid / norm.clamp(min=1e-20), P_a)  # all clipped: P_a
        nxt = _categorical(torch.log(resid.clamp(min=1e-30)), generator)
    slots = torch.arange(k + 1, device=tok.device)[None, :]
    d_pad = torch.cat([ds, torch.zeros_like(ds[:, :1])], dim=1)
    zero = torch.zeros_like(d_pad)
    emit = torch.where(slots < a[:, None], d_pad,
                       torch.where(slots == a[:, None], nxt[:, None], zero))
    cache_t["length"] = m_t + 1 + a
    return cache_t, emit, a, nxt


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, at: torch.Tensor) -> None:
    """buf[b, at[b] + j] = rows[b, j] in place, each start clamped so that
    the rows fit (as the JAX package's dynamic_update_slice clamps)."""
    width = rows.shape[1]
    cols = at.clamp(max=buf.shape[1] - width)[:, None] + torch.arange(width, device=buf.device)
    buf.scatter_(1, cols.long(), rows)


class SpeculativeEngine:
    """Draft + target speculative generation. ``config``/``params``: the
    target, whose law the output follows (float or quantized leaves);
    ``draft_config``/``draft_params``: the draft, or None for prompt
    lookup over ``ngram`` tokens. ``k`` proposals per round (a verify
    window of k + 1); ``kv_quant`` / ``draft_kv_quant``: "int8" caches.
    Runs on ``device="cuda"`` unless the caller asks for the CPU."""

    def __init__(
        self,
        config: GPTConfig,
        params,
        draft_config: Optional[GPTConfig] = None,
        draft_params=None,
        k: int = 4,
        batch_size: int = 1,
        max_seq: Optional[int] = None,
        prompt_buckets: Optional[Sequence[int]] = None,
        kv_quant: Optional[str] = None,
        draft_kv_quant: Optional[str] = None,
        ngram: int = 2,
        device="cuda",
    ):
        if k < 1:
            raise ValueError("k must be >= 1")
        for q in (kv_quant, draft_kv_quant):
            if q not in (None, "int8"):
                raise ValueError(f"unknown KV quantization {q!r} (None or 'int8')")
        self.device = resolve_device(device)
        self.config = _single_device_config(config, True, self.device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.k = k
        self.batch_size = batch_size
        self.ngram = None if draft_config is not None else max(int(ngram), 1)
        if draft_config is not None:
            self.draft_params = tree_map(lambda t: t.to(self.device), draft_params)
            self.draft_config = _single_device_config(draft_config, False, self.device)
            if self.draft_config.kv_packed:
                self.draft_params, self.draft_config = gpt2.pad_phantom_head(
                    self.draft_params, self.draft_config)
            self.max_seq = max_seq or min(config.context_size, draft_config.context_size)
        else:
            self.draft_config = self.draft_params = None
            self.max_seq = max_seq or config.context_size
        self.prompt_buckets = tuple(
            b for b in (prompt_buckets or (32, 128, 512, self.max_seq)) if b <= self.max_seq
        ) or (self.max_seq,)
        self.kv_quant = kv_quant
        self.draft_kv_quant = draft_kv_quant
        # A round appends up to k + 1 rows past the committed position
        # before acceptance rewinds; the token history has as much slack.
        self._rows = self.max_seq + k + 1
        self._hist_cap = self.max_seq + k + 1
        self.last_rounds: Optional[int] = None  # acceptance telemetry

    def _new_cache(self, target: bool):
        config, params, quant = ((self.config, self.params, self.kv_quant) if target else
                                 (self.draft_config, self.draft_params, self.draft_kv_quant))
        return gpt2.init_kv_cache(config, self.batch_size, self._rows,
                                  dtype=params["wte"].dtype, device=self.device, quant=quant)

    # -- the round -------------------------------------------------------------

    def _draw(self, logits, state, sampling: SamplingConfig):
        if sampling.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return _categorical(_scaled(logits, sampling.temperature, sampling.top_k,
                                    sampling.top_p), state["generator"])

    def _propose_draft(self, state, sampling: SamplingConfig):
        """The draft's k proposals (B, k) and, when sampling, their laws
        (B, k, V): the catch-up extend, then k - 1 decode steps."""
        cache, pend, pv, tok = state["cache_d"], state["pend"], state["pv"], state["tok"]
        window = torch.stack([torch.where(pv, pend, tok),
                              torch.where(pv, tok, torch.zeros_like(tok))], dim=1)
        valid = 1 + pv.to(torch.int32)
        cache, logits = gpt2.extend(self.draft_params, cache, window, valid, self.draft_config)
        logits = logits.gather(
            1, (valid - 1).long()[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
        ds, qs = [], []
        for i in range(self.k):
            if i:
                cache, logits = gpt2.decode_step(self.draft_params, cache, ds[-1],
                                                 self.draft_config)
            ds.append(self._draw(logits, state, sampling))
            if not sampling.greedy:
                qs.append(_probs(logits, sampling.temperature, sampling.top_k, sampling.top_p))
        state["cache_d"] = cache
        return torch.stack(ds, dim=1), (torch.stack(qs, dim=1) if qs else None)

    def _round(self, state, sampling: SamplingConfig):
        """One round on ``state`` (cache_t, the draft's state or the token
        history, tok, generator), updated in place: returns this round's
        (B, k + 1) emit slots and the count committed per lane (B,)."""
        k = self.k
        m_t = state["cache_t"]["length"]
        if self.ngram is None:
            ds, Q = self._propose_draft(state, sampling)
        else:
            ds, Q = _propose_ngram(state["hist"], state["hist_len"], state["tok"], k=k,
                                   ngram=self.ngram), None
        state["cache_t"], emit, a, nxt = _verify_accept_commit(
            self.params, self.config, state["cache_t"], state["tok"], ds, Q,
            state["generator"], k=k, greedy=sampling.greedy, temperature=sampling.temperature,
            top_k=sampling.top_k, top_p=sampling.top_p)
        if self.ngram is None:
            # The draft processed the catch-up and k - 1 proposals; the
            # committed prefix is shorter (a < k) or one longer (a == k: d_k
            # still pending, carried by pend/pv).
            cache_d = state["cache_d"]
            cache_d["length"] = torch.minimum(m_t + 1 + a, cache_d["length"])
            state["pend"], state["pv"] = ds[:, k - 1], a == k
        else:
            _write_rows(state["hist"], emit, state["hist_len"])
            state["hist_len"] = state["hist_len"] + a + 1
        state["tok"] = nxt
        return emit, a + 1

    def _prefill_and_sample(self, toks: torch.Tensor, lens: torch.Tensor,
                            sampling: SamplingConfig):
        """Fresh caches, the target's (and draft's) prefill, the first token
        drawn from the target's prefill logits, and the round state."""
        generator = torch.Generator(device=self.device).manual_seed(sampling.seed)
        cache_t, logits = gpt2.prefill(self.params, self._new_cache(True), toks, lens,
                                       self.config)
        state = {"cache_t": cache_t, "generator": generator}
        state["tok"] = self._draw(logits, state, sampling)
        B = self.batch_size
        if self.ngram is None:
            state["cache_d"], _ = gpt2.prefill(self.draft_params, self._new_cache(False), toks,
                                               lens, self.draft_config)
            state["pend"] = torch.zeros((B,), dtype=torch.int32, device=self.device)
            state["pv"] = torch.zeros((B,), dtype=torch.bool, device=self.device)
        else:  # the history: the prompt, then the first token at its length
            hist = torch.zeros((B, self._hist_cap), dtype=torch.int32, device=self.device)
            width = min(toks.shape[1], self._hist_cap)
            hist[:, :width] = toks[:, :width]
            hist.scatter_(1, lens.long()[:, None], state["tok"][:, None])
            state["hist"], state["hist_len"] = hist, lens + 1
        return state

    def _tensor(self, data) -> torch.Tensor:
        return torch.as_tensor(np.asarray(data, np.int32), device=self.device)

    # -- public API ------------------------------------------------------------

    def generate_scan(self, prompt_ids: np.ndarray, lengths: Sequence[int], n_steps: int,
                      sampling: SamplingConfig = SamplingConfig()) -> np.ndarray:
        """Batched speculative generation, InferenceEngine.generate_scan's
        contract: (B, T) right-padded prompts and their lengths -> (B,
        n_steps) ids (the token drawn from the prefill logits is consumed,
        not returned). Rounds run until every lane has n_steps tokens: one
        host read per round."""
        prompt_ids = np.asarray(prompt_ids)
        if prompt_ids.shape[0] != self.batch_size:
            raise ValueError(f"batch {prompt_ids.shape[0]} != engine batch_size "
                             f"{self.batch_size}")
        if max(lengths) + n_steps > self.max_seq:
            raise ValueError("prompt + n_steps exceeds max_seq")
        state = self._prefill_and_sample(self._tensor(prompt_ids), self._tensor(lengths),
                                         sampling)
        B = self.batch_size
        buf = torch.zeros((B, n_steps + self.k + 1), dtype=torch.int32, device=self.device)
        cursor = torch.zeros((B,), dtype=torch.int32, device=self.device)
        rounds = 0
        while int(cursor.min()) < n_steps:  # the round's one host read
            emit, n = self._round(state, sampling)
            _write_rows(buf, emit, cursor)
            cursor = cursor + n
            rounds += 1
        self.last_rounds = rounds
        return buf[:, :n_steps].cpu().numpy()

    def generate_iter(self, prompt_ids: Sequence[int], max_new_tokens: Optional[int] = None,
                      sampling: SamplingConfig = SamplingConfig(),
                      stop_tokens: Sequence[int] = (),
                      metrics: Optional[GenerationMetrics] = None):
        """Single-sequence streaming: the prefill's token first, then up to
        k + 1 tokens per round, one host read per round; stop and budget
        checks per round, overshoot discarded (InferenceEngine.generate_iter's
        visible semantics)."""
        if self.batch_size != 1:
            raise ValueError("generate_iter is single-sequence")
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise ValueError("prompt must contain at least one token")
        n = len(prompt_ids)
        budget = self.max_seq - n
        steps = budget if max_new_tokens is None else min(max_new_tokens, budget)
        metrics = metrics if metrics is not None else GenerationMetrics()
        metrics.prompt_tokens = n
        tokens = np.zeros((1, _bucket(n, self.prompt_buckets)), np.int32)
        tokens[0, :n] = prompt_ids
        t0 = time.perf_counter()
        state = self._prefill_and_sample(self._tensor(tokens), self._tensor([n]), sampling)
        first = int(state["tok"][0])  # one sync, like the engine's first token
        metrics.prefill_ms = (time.perf_counter() - t0) * 1000.0
        self.last_rounds = 0

        def fetch():
            emit, count = self._round(state, sampling)
            self.last_rounds += 1
            row = torch.cat([count[:1], emit[0]]).cpu().tolist()  # one host read
            return row[1:1 + row[0]]

        t_decode = time.perf_counter()
        yield from _drain_stream(first, steps, set(stop_tokens), metrics, fetch)
        metrics.decode_ms = (time.perf_counter() - t_decode) * 1000.0

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: Optional[int] = None,
                 sampling: SamplingConfig = SamplingConfig(), stop_tokens: Sequence[int] = (),
                 metrics: Optional[GenerationMetrics] = None):
        """``generate_iter`` collected into a list."""
        return list(self.generate_iter(prompt_ids, max_new_tokens, sampling, stop_tokens,
                                       metrics=metrics))

    def generate_text(self, prompt: str, encoder, max_new_tokens: Optional[int] = None,
                      sampling: SamplingConfig = SamplingConfig(), stream_to=None,
                      metrics: Optional[GenerationMetrics] = None,
                      stop_tokens: Sequence[int] = ()) -> str:
        """Prompt string -> generated string, streamed per round."""
        decoder = StreamDecoder(encoder)
        pieces = []

        def emit(text):
            if text:
                pieces.append(text)
                if stream_to is not None:
                    stream_to.write(text)
                    stream_to.flush()

        for tok in self.generate_iter(encoder.encode(prompt), max_new_tokens, sampling,
                                      stop_tokens, metrics=metrics):
            emit(decoder.push(tok))
        emit(decoder.flush())
        return "".join(pieces)

    @property
    def acceptance_stats(self) -> Optional[dict]:
        """After a generation: its rounds and k (tokens per round = tokens /
        rounds; the ceiling is k + 1)."""
        if self.last_rounds is None:
            return None
        return {"rounds": self.last_rounds, "k": self.k}
