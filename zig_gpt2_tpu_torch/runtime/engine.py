"""Generation runtime: streaming KV-cached decode on one device.

Counterpart of ``zig_gpt2_tpu.runtime.engine``. Prefill runs the whole
prompt, right-padded to a bucket, in one pass; each decode step runs
``gpt2.decode_step`` and ``sampling.sample`` and updates the engine's KV
cache in place. Text streams out through ``StreamDecoder``, which never
emits a partial UTF-8 character.

The engine runs on ``device="cuda"`` unless the caller asks for
``device="cpu"``; with no card and no explicit CPU request it raises. It
decides the KV cache's layout at construction, as the JAX package's
``prepare_serving`` does on one device (``gpt2.prepare_serving``: packed
on the card at head_dim 64 unless ``ZG2_KV_PACKED=0``, with an odd head
count's phantom head added to the weights).

Prefix caching (``register_prefix``): the KV rows of a shared prompt
prefix are computed once and kept; a later prompt that starts with it
(``match_prefix``: the longest usable overlap) copies the stored rows and
runs only its suffix, as one ``gpt2.extend`` window. The stored cache is
never written by a hit.

Tensor- and data-parallel serving (``mesh=``, a ``parallel.mesh.Mesh``):
every rank of the mesh builds the engine from the same full weights and
keeps its shard (``parallel.mesh.prepare_serving``); each data rank holds
batch_size / dp lanes, each model rank the per-shard tensors, and every
step runs the per-rank model (its collectives on the model group) and the
vocab-sharded draw ``sampling.sample_manual``. Every rank returns the same
tokens: a rank's lanes are gathered over the data group. Prefix caching
serves under a mesh too (batch_size 1, so dp 1, as in the JAX package):
each rank stores the prefix rows of its own heads, and a hit's suffix
extend runs through the per-rank collective sites. A config with
``seq_parallel`` prefills sequence-parallel over the model group
(``models.gpt2``). The mesh must live on the engine's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from zig_gpt2_tpu_torch.config import GPTConfig, SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.runtime.sampling import data_rank_seed, sample, sample_manual
from zig_gpt2_tpu_torch.utils.device import device_key, resolve_device
from zig_gpt2_tpu_torch.weights import tree_map


class StreamDecoder:
    """Incremental detokenizer that buffers incomplete UTF-8 tails
    (byte-level BPE tokens can split a multi-byte character)."""

    def __init__(self, encoder):
        self.encoder = encoder
        self._pending = b""

    def push(self, token_id: int) -> str:
        data = self._pending + self.encoder.decode_bytes([token_id])
        for cut in range(len(data), max(len(data) - 4, -1), -1):
            try:
                text = data[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            self._pending = data[cut:]
            return text
        self._pending = data
        return ""

    def flush(self) -> str:
        text = self._pending.decode("utf-8", errors="replace")
        self._pending = b""
        return text


@dataclass
class GenerationMetrics:
    """Per-request metrics, host clock around work that ends in a sync."""

    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    per_token_ms: List[float] = field(default_factory=list)
    prefix_tokens_reused: int = 0  # prompt rows served from the prefix cache

    @property
    def ms_per_token(self) -> float:
        return self.decode_ms / max(self.generated_tokens, 1)

    @property
    def tokens_per_sec(self) -> float:
        return 1000.0 * self.generated_tokens / max(self.decode_ms, 1e-9)

    def ms_per_token_percentile(self, q: float) -> float:
        if not self.per_token_ms:
            return 0.0
        return float(np.percentile(self.per_token_ms, q))


def _drain_stream(first: int, steps: int, stops, metrics: GenerationMetrics,
                  fetch: Callable[[], List[int]], first_ms: float = 0.0):
    """Yield tokens batch by batch, enforcing the step budget and the stop
    set per token (the stop token itself is not yielded; overshoot past the
    budget is discarded). ``fetch()`` returns the next batch after one
    device round-trip; its wall time is spread over its tokens."""
    pending = [first]
    pending_ms = first_ms
    emitted = 0
    while True:
        for t in pending:
            if emitted >= steps or t in stops:
                return
            metrics.generated_tokens += 1
            metrics.per_token_ms.append(pending_ms)
            emitted += 1
            yield t
        if emitted >= steps:
            return
        t1 = time.perf_counter()
        pending = fetch()
        pending_ms = (time.perf_counter() - t1) * 1000.0 / max(len(pending), 1)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket {buckets[-1]}")


def match_prefix(prefixes, prompt, buckets, cache_rows):
    """Longest usable stored-prefix overlap for ``prompt``: (prefix index,
    usable rows) or None; ``prefixes`` is [(token tuple, stored cache)],
    the engine's and the batcher's one policy. ``usable`` is at most
    len(prompt) - 1 (a suffix token must remain to give the first token's
    logits) and shrinks until the bucket-padded suffix window fits
    ``cache_rows`` (the suffix extend writes a whole bucket at row
    ``usable``; past the cache its start would clamp back over prefix
    rows). A shrink can only grow the bucket, so the loop ends."""
    best = None
    for pidx, (ptoks, _pre) in enumerate(prefixes):
        cap = min(len(ptoks), len(prompt) - 1)
        k = 0
        while k < cap and prompt[k] == ptoks[k]:
            k += 1
        while k >= 1:
            sb = _bucket(len(prompt) - k, buckets)
            if k + sb <= cache_rows:
                break
            k = cache_rows - sb
        if k >= 1 and (best is None or k > best[1]):
            best = (pidx, k)
    return best


def _check_mesh(mesh, device: torch.device) -> None:
    """A runtime's mesh: a ``parallel.mesh.Mesh`` (TypeError) whose tensors
    live on the runtime's device (ValueError)."""
    from zig_gpt2_tpu_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    if device_key(mesh.device) != device_key(device):
        raise ValueError(f"the mesh lives on {mesh.device}, the runtime on {device}: make the "
                         f"mesh on the runtime's device (make_mesh(..., device=))")


class InferenceEngine:
    """Single-model generation engine owning the parameters and KV cache."""

    def __init__(
        self,
        config: GPTConfig,
        params,
        encoder=None,
        batch_size: int = 1,
        max_seq: Optional[int] = None,
        prompt_buckets: Optional[Sequence[int]] = None,
        decode_chunk: Optional[int] = None,
        device="cuda",
        kv_quant: Optional[str] = None,
        cache_dtype: Optional[torch.dtype] = None,
        mesh=None,
    ):
        """``decode_chunk``: decode steps run per host sync in the streaming
        path. Stop and budget checks happen per chunk and overshoot is
        discarded, so the visible output does not depend on it; the cache
        carries decode_chunk - 1 headroom rows for the discarded steps.
        Default 1 (no measurement on the card says otherwise yet).

        ``kv_quant``: None for a float KV cache in ``cache_dtype`` (default
        the weights' (wte's) dtype), or "int8" for int8 rows with f32 scales
        per (token, head), or per (token, head pair) in the packed layout.
        ``params`` may be float or quantized (``quant.quantize_params``).

        ``mesh``: serve over a ``parallel.mesh.Mesh``; ``params`` are the
        full weights (a quantized tree already padded and aligned for the
        mesh's tp), batch_size must divide by its dp."""
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown KV quantization {kv_quant!r} (None or 'int8')")
        self.device = resolve_device(device)
        self.kv_quant = kv_quant
        self.mesh = mesh
        if mesh is None:
            self.params, self.config = gpt2.prepare_serving(
                tree_map(lambda t: t.to(self.device), params), config, self.device)
            self._lanes = batch_size
        else:
            from zig_gpt2_tpu_torch.parallel.mesh import prepare_serving

            _check_mesh(mesh, self.device)
            self.params, self.config = prepare_serving(params, config, mesh, batch_size,
                                                       self.device)
            self._lanes = batch_size // mesh.dp
        self.cache_dtype = cache_dtype or self.params["wte"].dtype
        self.encoder = encoder
        self.batch_size = batch_size
        self.max_seq = max_seq or config.context_size
        self.prompt_buckets = tuple(
            b for b in (prompt_buckets or (32, 128, 512, config.context_size))
            if b <= self.max_seq
        ) or (self.max_seq,)
        self.decode_chunk = max(int(decode_chunk or 1), 1)
        self._cache_rows = self.max_seq + (self.decode_chunk - 1)
        # Prefix cache: [(token tuple, stored B=1 cache)], longest first.
        self._prefixes: List[tuple] = []

    def new_cache(self) -> gpt2.KVCache:
        return gpt2.init_kv_cache(self.config, self._lanes, self._cache_rows,
                                  dtype=self.cache_dtype, device=self.device,
                                  quant=self.kv_quant)

    def register_prefix(self, prefix_ids: Sequence[int]) -> None:
        """Compute and keep the KV rows of a shared prompt prefix (a system
        prompt): a later prompt that shares leading tokens with it starts
        from the stored rows and runs only its suffix. Output is unchanged.
        Single-sequence (batch_size 1; the batcher has its own). Under a
        mesh each rank keeps the rows of its own heads."""
        if self.batch_size != 1:
            raise ValueError("register_prefix is single-sequence (batch_size == 1); "
                             "use ContinuousBatcher")
        prefix_ids = [int(t) for t in prefix_ids]
        if not prefix_ids:
            raise ValueError("prefix must contain at least one token")
        n = len(prefix_ids)
        tokens = np.zeros((1, _bucket(n, self.prompt_buckets)), np.int32)  # raises if too long
        tokens[0, :n] = prefix_ids
        pre, _ = self._prefill(tokens, [n])
        self._prefixes.append((tuple(prefix_ids), pre))
        self._prefixes.sort(key=lambda t: -len(t[0]))

    def _prefix_prefill(self, prompt_ids: List[int], pidx: int, usable: int):
        """A prefix hit's prefill: a copy of the stored rows, its length set
        to ``usable``, and one extend over the bucket-padded suffix.
        Returns (cache, the last suffix position's (1, vocab) logits)."""
        suffix = prompt_ids[usable:]
        tokens = np.zeros((1, _bucket(len(suffix), self.prompt_buckets)), np.int32)
        tokens[0, :len(suffix)] = suffix
        cache = {name: t.clone() for name, t in self._prefixes[pidx][1].items()}
        cache["length"] = self._tensor([usable])
        cache, logits = gpt2.extend(self.params, cache, self._tensor(tokens),
                                    self._tensor([len(suffix)]), self.config)
        return cache, logits[:, len(suffix) - 1]

    def _tensor(self, data) -> torch.Tensor:
        return torch.as_tensor(np.asarray(data, np.int32), device=self.device)

    def _prefill(self, prompts: np.ndarray, lengths: Sequence[int]):
        return gpt2.prefill(self.params, self.new_cache(), self._tensor(prompts),
                            self._tensor(lengths), self.config)

    def _run_chunk(self, n: int, cache, token, generator, sampling: SamplingConfig):
        """n decode + sample steps with no host sync: returns the (n, B)
        tokens (on the device) and the last token."""
        toks = []
        for _ in range(n):
            cache, logits = gpt2.decode_step(self.params, cache, token, self.config)
            token = self._draw(logits, generator, sampling)
            toks.append(token)
        return torch.stack(toks), token

    def _draw(self, logits, generator, sampling: SamplingConfig) -> torch.Tensor:
        """(lanes,) next tokens: ``sample``, or under a mesh the
        vocab-sharded ``sample_manual`` over the model group."""
        if self.mesh is None:
            return sample(logits, generator, sampling.temperature, sampling.top_k,
                          sampling.top_p)
        return sample_manual(logits, generator, sampling.temperature, sampling.top_k,
                             sampling.top_p, self.mesh.model)

    def _generator(self, sampling: SamplingConfig) -> torch.Generator:
        """The draw's generator: seeded from ``sampling.seed``, per data rank
        under a mesh (``data_rank_seed``)."""
        seed = sampling.seed
        if self.mesh is not None:
            seed = data_rank_seed(seed, self.mesh.data_index, self.mesh.dp)
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- streaming generation -------------------------------------------------

    def generate(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        sampling: SamplingConfig = SamplingConfig(),
        stop_tokens: Sequence[int] = (),
        on_token: Optional[Callable[[int], None]] = None,
        metrics: Optional[GenerationMetrics] = None,
    ) -> List[int]:
        """Generate from one prompt, streaming tokens via ``on_token``.
        ``max_new_tokens=None`` runs to the end of the context window."""
        out: List[int] = []
        for tok in self.generate_iter(prompt_ids, max_new_tokens, sampling,
                                      stop_tokens, metrics):
            if on_token is not None:
                on_token(tok)
            out.append(tok)
        return out

    def generate_iter(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        sampling: SamplingConfig = SamplingConfig(),
        stop_tokens: Sequence[int] = (),
        metrics: Optional[GenerationMetrics] = None,
    ) -> Iterator[int]:
        if self.batch_size != 1:
            raise ValueError("generate_iter is single-sequence (batch_size == 1)")
        prompt_ids = list(prompt_ids)
        if not prompt_ids:
            raise ValueError("prompt must contain at least one token")
        n = len(prompt_ids)
        budget = self.max_seq - n
        steps = budget if max_new_tokens is None else min(max_new_tokens, budget)
        metrics = metrics if metrics is not None else GenerationMetrics()
        metrics.prompt_tokens = n

        t0 = time.perf_counter()
        hit = (match_prefix(self._prefixes, prompt_ids, self.prompt_buckets, self._cache_rows)
               if self._prefixes else None)
        if hit is not None:
            cache, logits = self._prefix_prefill(prompt_ids, *hit)
            metrics.prefix_tokens_reused = hit[1]
        else:
            tokens = np.zeros((1, _bucket(n, self.prompt_buckets)), np.int32)
            tokens[0, :n] = prompt_ids
            cache, logits = self._prefill(tokens, [n])
        generator = self._generator(sampling)
        token = self._draw(logits, generator, sampling)
        first = int(token[0])  # one sync: prefill time includes the first draw
        metrics.prefill_ms = (time.perf_counter() - t0) * 1000.0

        stops = set(stop_tokens)
        t_decode = time.perf_counter()
        if self.decode_chunk == 1:
            tok_host = first
            for _ in range(steps):
                t1 = time.perf_counter()
                if tok_host in stops:
                    break
                cache, logits = gpt2.decode_step(self.params, cache, token, self.config)
                token = self._draw(logits, generator, sampling)
                nxt = int(token[0])  # one host sync per token
                metrics.generated_tokens += 1
                metrics.per_token_ms.append((time.perf_counter() - t1) * 1000.0)
                yield tok_host
                tok_host = nxt
            metrics.decode_ms = (time.perf_counter() - t_decode) * 1000.0
            return

        state = {"cache": cache, "token": token}

        def fetch():
            toks, state["token"] = self._run_chunk(
                self.decode_chunk, state["cache"], state["token"], generator, sampling)
            return [int(v) for v in toks[:, 0].cpu()]  # one sync per chunk

        yield from _drain_stream(first, steps, stops, metrics, fetch)
        metrics.decode_ms = (time.perf_counter() - t_decode) * 1000.0

    def generate_text(
        self,
        prompt: str,
        max_new_tokens: Optional[int] = None,
        sampling: SamplingConfig = SamplingConfig(),
        stream_to=None,
        metrics: Optional[GenerationMetrics] = None,
        stop_tokens: Sequence[int] = (),
    ) -> str:
        """Prompt string -> generated string, optionally streaming each
        piece to a file-like object as it is produced."""
        if self.encoder is None:
            raise ValueError("engine constructed without a tokenizer")
        ids = self.encoder.encode(prompt)
        decoder = StreamDecoder(self.encoder)
        pieces: List[str] = []

        def emit(text):
            if text:
                pieces.append(text)
                if stream_to is not None:
                    stream_to.write(text)
                    stream_to.flush()

        for tok in self.generate_iter(ids, max_new_tokens, sampling, stop_tokens,
                                      metrics=metrics):
            emit(decoder.push(tok))
        emit(decoder.flush())
        return "".join(pieces)

    # -- batched generation (benchmark path) ----------------------------------

    def generate_scan(
        self,
        prompt_ids: np.ndarray,
        lengths: Sequence[int],
        n_steps: int,
        sampling: SamplingConfig = SamplingConfig(),
    ) -> np.ndarray:
        """Batched generation with no host sync inside the token loop.

        prompt_ids: (B, T) right-padded prompts; lengths: true lengths.
        Returns (B, n_steps) ids: the tokens sampled after each of the
        n_steps decode steps (the token drawn from the prefill logits
        feeds the first step and is not among them, as in the JAX engine).
        Under a mesh each data rank runs its B / dp rows and every rank
        returns all B.
        """
        prompt_ids, lengths = np.asarray(prompt_ids), np.asarray(lengths)
        if self.mesh is not None:
            rows = slice(self.mesh.data_index * self._lanes,
                         (self.mesh.data_index + 1) * self._lanes)
            prompt_ids, lengths = prompt_ids[rows], lengths[rows]
        cache, logits = self._prefill(prompt_ids, lengths)
        generator = self._generator(sampling)
        token = self._draw(logits, generator, sampling)
        toks, _ = self._run_chunk(n_steps, cache, token, generator, sampling)
        if self.mesh is not None and self.mesh.dp > 1:  # (dp, n, B/dp) -> (n, B)
            toks = self.mesh.data.all_gather(toks).permute(1, 0, 2).reshape(n_steps, -1)
        return toks.T.cpu().numpy()
