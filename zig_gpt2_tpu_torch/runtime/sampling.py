"""Token sampling.

Counterpart of ``zig_gpt2_tpu.runtime.sampling.sample`` and
``_mask_logits``. Temperature 0 is a greedy argmax. Otherwise the draw is
the Gumbel-max sampler (``ops.sampling_kernel.sample_categorical``: the
CUDA kernel on the card, its plain version on the CPU), fed one seed per
row drawn from an explicit ``torch.Generator``. Top-k and top-p become a
per-row threshold, the smallest kept raw logit, which the sampler turns
into a support mask; the kept set is computed by the same masking code as
the JAX package's.

``sample_manual`` is the vocab-sharded draw of tensor-parallel serving
(the JAX package's ``sample_manual``): each rank holds a (B, V/tp) slice of
the logits, draws its own noise with the sampler's ``return_max`` (its
winning z* beside its id), and the argmax of the winners across the model
group is the global Gumbel-max draw, the same on every rank.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from zig_gpt2_tpu_torch.ops.sampling_kernel import sample_categorical
from zig_gpt2_tpu_torch.parallel.shard_kernels import combine_shards, decorrelate_seeds

_SEED_HIGH = 2 ** 31 - 1


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float = 1.0, top_k: Optional[int] = None,
           top_p: Optional[float] = None) -> torch.Tensor:
    """Draw next tokens from (B, vocab) logits -> (B,) int32.

    ``generator`` lives on the logits' device; each call with temperature
    > 0 draws B seeds from it, so a seeded generator makes the stream
    reproducible. It is not read for greedy decoding."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    seeds = torch.randint(0, _SEED_HIGH, (logits.shape[0],), generator=generator,
                          device=logits.device, dtype=torch.int32)
    return sample_categorical(logits, seeds, temperature,
                              _threshold(logits, temperature, top_k, top_p))


def data_rank_seed(seed: int, index: int, dp: int) -> int:
    """The sampling seed of data rank ``index`` of ``dp``: ``seed`` itself
    for dp 1, else a hash of both, so that lanes on different data ranks
    draw independent noise (the JAX package folds the data index into its
    key)."""
    if dp == 1:
        return seed
    digest = hashlib.sha256(f"{seed}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def sample_manual(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_k: Optional[int], top_p: Optional[float],
                  group) -> torch.Tensor:
    """Draw from this rank's (B, V/tp) contiguous vocab slice of the logits
    -> (B,) int32 GLOBAL ids, the same on every rank of ``group`` (the
    model axis's ``Collectives``). Greedy is a two-level argmax. Otherwise
    each rank's seeds (B drawn from ``generator``, which every rank of the
    group keeps in step) are decorrelated by its index, the sampler returns
    its id and z* (``return_max``: the kernel on the card, its plain
    version on the CPU), and the argmax of z* over the ranks wins (ties to
    the lowest rank). Top-k and top-p take their threshold from an
    all-gather of the raw logits; the top-k gate compares against the
    global width V/tp * tp. Two all-gathers per draw (z* and the ids)."""
    vl = logits.shape[-1]
    if temperature == 0.0:
        z, idx = logits.float().max(-1)
        idx = idx.to(torch.int32)
    else:
        thresh = None
        if (top_k is not None and top_k < vl * group.size) or (top_p is not None
                                                                and top_p < 1.0):
            thresh = _threshold(group.all_gather_cat(logits.float(), dim=-1), temperature,
                                top_k, top_p)
        seeds = torch.randint(0, _SEED_HIGH, (logits.shape[0],), generator=generator,
                              device=logits.device, dtype=torch.int32)
        idx, z = sample_categorical(logits, decorrelate_seeds(seeds, group.index), temperature,
                                    thresh, return_max=True)
    return combine_shards(group.all_gather(z), group.all_gather(idx), vl)


def _threshold(logits: torch.Tensor, temperature: float, top_k: Optional[int],
               top_p: Optional[float]) -> Optional[torch.Tensor]:
    """(B,) f32 smallest kept raw logit under top-k / top-p, or None when
    neither truncates. The kept set is always a prefix of the sorted row,
    so a threshold on the raw logit (an actual element, no /T*T rounding)
    describes it exactly."""
    if not ((top_k is not None and top_k < logits.shape[-1])
            or (top_p is not None and top_p < 1.0)):
        return None
    raw = logits.float()
    scaled = _mask_logits(raw / temperature, top_k, top_p)
    return torch.where(torch.isneginf(scaled), torch.inf, raw).amin(-1).contiguous()


def _mask_logits(logits: torch.Tensor, top_k: Optional[int],
                 top_p: Optional[float]) -> torch.Tensor:
    """Set logits outside the top-k / nucleus support to -inf."""
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if top_p is not None and top_p < 1.0:
        # Keep the smallest prefix of the sorted distribution whose mass
        # reaches top_p; the token that crosses it stays in.
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p  # the first token is always kept
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return logits
