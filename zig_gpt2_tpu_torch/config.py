"""Model and sampling configuration for the GPT-2 family.

The port's own copy of ``zig_gpt2_tpu.config``: the same names, fields and
values, so one configuration describes a model in both packages. Fields
that only steer the JAX package's XLA sharding (``spmd``, ``mesh``,
``manual_axis``) are left out; the fields that change results are kept,
and ``seq_parallel``, which the port serves under a mesh. Tensor-parallel
serving adds fields of its own on ``RankConfig``, a rank's per-shard
config (``parallel.mesh.local_config``): ``model_group`` carries the
model-axis group, and the model then inserts its collectives; ``op_level``
picks which of the JAX package's two mesh programs a decode step follows.
On ``GPTConfig`` both are class attributes, so that a config's fields stay
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Architecture hyperparameters for a GPT-2 style decoder-only model."""

    vocab_size: int = 50257
    context_size: int = 1024
    n_layers: int = 12
    n_heads: int = 12
    n_embed: int = 768
    layer_norm_eps: float = 1e-5
    # Padding for tensor parallelism: padded heads are inert (zero weights),
    # padded vocab logits are masked before sampling. None = unpadded.
    padded_heads: Optional[int] = None
    padded_vocab_size: Optional[int] = None
    # Head-pair-packed KV layout (head_dim 64): two heads per cache row and,
    # for an INT8 cache, one scale per head pair. The runtimes set it by
    # models.gpt2.default_kv_packed.
    kv_packed: bool = False
    # Every batch lane decodes at one shared position (a write-path
    # optimisation in the JAX package; results are unchanged).
    uniform_pos: bool = False
    # w8a8: per-channel INT8 linears quantize their activations per row and
    # take s8 x s8 products (quant.quantize.quantized_linear); the CLI sets
    # it for --quant w8a8.
    act_quant: bool = False
    # Ring KV cache for continuous batching; the batcher sets it unless
    # ZG2_RING=0.
    ring_cache: bool = False
    # Sequence-parallel prefill (and forward) under a mesh: the residual
    # stream between the linears is split over the model ranks by sequence
    # position (models.gpt2); no effect on one device. Results are the
    # plain tensor-parallel ones.
    seq_parallel: bool = False
    # No model group on one device (see RankConfig).
    model_group: ClassVar[Optional[object]] = None
    op_level: ClassVar[bool] = False

    @property
    def head_dim(self) -> int:
        return self.n_embed // self.n_heads

    @property
    def attn_heads(self) -> int:
        """Head count materialized in weights and cache (>= n_heads)."""
        return self.padded_heads or self.n_heads

    @property
    def vocab_rows(self) -> int:
        """Vocab rows materialized in wte (>= vocab_size)."""
        return self.padded_vocab_size or self.vocab_size

    @property
    def n_params(self) -> int:
        """Approximate parameter count (lm_head tied to wte)."""
        E = self.n_embed
        per_block = (4 * E + E * 3 * E + 3 * E + E * E + E
                     + E * 4 * E + 4 * E + 4 * E * E + E)
        return (self.vocab_size * E + self.context_size * E
                + self.n_layers * per_block + 2 * E)


@dataclasses.dataclass(frozen=True)
class RankConfig(GPTConfig):
    """A rank's per-shard config under tensor parallelism
    (``parallel.mesh.local_config``): ``model_group`` is the model axis's
    ``parallel.distributed.Collectives``. The shapes are then shards (the
    attention heads, the column linears' N, the row linears' K, the vocab
    rows), and ``models.gpt2`` all-reduces after the embedding and each
    row-parallel linear and masks phantom vocab by global id.

    ``op_level``: ``decode_step`` follows the JAX package's op-level
    (GSPMD) mesh program, which quantizes a w8a8 c_proj row over its whole
    K, instead of its step-level body (over the rank's K, the default).
    The speculative batcher sets it under a mesh, where the JAX batcher
    takes the op-level placement."""

    model_group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    op_level: bool = False


GPT2_124M = GPTConfig(50257, 1024, 12, 12, 768)
GPT2_355M = GPTConfig(50257, 1024, 24, 16, 1024)
GPT2_774M = GPTConfig(50257, 1024, 36, 20, 1280)
GPT2_1558M = GPTConfig(50257, 1024, 48, 25, 1600)

# Tiny configs for tests.
GPT2_NANO = GPTConfig(vocab_size=512, context_size=128, n_layers=2, n_heads=4, n_embed=128)
GPT2_MICRO = GPTConfig(vocab_size=1024, context_size=256, n_layers=4, n_heads=4, n_embed=256)

CONFIGS = {
    "124M": GPT2_124M,
    "355M": GPT2_355M,
    "774M": GPT2_774M,
    "1558M": GPT2_1558M,
    "1.5B": GPT2_1558M,
    "nano": GPT2_NANO,
    "micro": GPT2_MICRO,
}


def get_config(name: str) -> GPTConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown model config {name!r}; choices: {sorted(CONFIGS)}") from None


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling hyperparameters: temperature (0 = greedy), optional top-k
    and top-p, and the seed of the engine's torch.Generator."""

    temperature: float = 0.8
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0
