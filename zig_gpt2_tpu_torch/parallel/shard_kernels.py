"""The per-rank pieces of the JAX package's sharded kernels.

Counterpart of ``zig_gpt2_tpu.parallel.shard_kernels``. The JAX package
wraps its kernels in ``shard_map`` so that each device sees its shard; a
rank of the port holds its shard already and calls the same kernels on it
(``qmm`` over N/tp columns or K/tp rows, decode attention over H/tp heads,
the sampler over V/tp ids). What is left are the index rules those
wrappers apply:

- ``int4_row_shard_slices``: the features of a K-sharded, half-split
  packed INT4 weight;
- ``decorrelate_seeds`` and ``combine_shards``: the vocab-sharded
  Gumbel-max draw (each rank draws its own noise; the cross-rank argmax of
  the winning perturbed values is the global draw);
- ``w8a8_row_full_partial``: a row-parallel w8a8 product whose
  activations are quantized over the whole row, as the JAX package's GSPMD
  programs quantize them.
"""

from __future__ import annotations

import torch

from zig_gpt2_tpu_torch.quant import kernels
from zig_gpt2_tpu_torch.quant.quantize import _int_mm_takes

_GOLDEN = -1640531527  # the odd golden-ratio constant, as an int32


def int4_row_shard_slices(x: torch.Tensor, scale: torch.Tensor, tp: int, index: int):
    """This rank's features of FULL activations ``x`` (rows, K) and scales
    for a K-sharded packed-INT4 row-parallel product. The half-split pack
    puts features [0, K/2) in the low nibbles and [K/2, K) in the high
    ones, so rank i's contiguous packed rows cover [i K/2tp, (i+1) K/2tp)
    and [K/2 + i K/2tp, K/2 + (i+1) K/2tp): x is sliced to those two ranges
    (in that order) and grouped scales (..., K/G, N) likewise (groups stay
    whole: G divides K/(2 tp)); per-channel scales pass as they are."""
    k = x.shape[1]
    kh = k // (2 * tp)
    x = torch.cat([x[:, index * kh:(index + 1) * kh],
                   x[:, k // 2 + index * kh:k // 2 + (index + 1) * kh]], dim=1)
    if scale.shape[-2] != 1:
        g = scale.shape[-2]
        gh = g // (2 * tp)
        scale = torch.cat([scale[..., index * gh:(index + 1) * gh, :],
                           scale[..., g // 2 + index * gh:g // 2 + (index + 1) * gh, :]],
                          dim=-2)
    return x.contiguous(), scale.contiguous()


def decorrelate_seeds(seeds: torch.Tensor, index: int) -> torch.Tensor:
    """Rank ``index``'s seeds: seeds ^ ((index + 1) * -1640531527) in int32
    arithmetic, so that each vocab shard draws its own noise."""
    c = ((index + 1) * _GOLDEN + 2 ** 31) % 2 ** 32 - 2 ** 31
    return seeds ^ torch.tensor(c, dtype=torch.int32, device=seeds.device)


def combine_shards(z_all: torch.Tensor, idx_all: torch.Tensor, vl: int) -> torch.Tensor:
    """(tp, B) winning values and local ids of every shard -> (B,) global
    int32 ids: the argmax over shards (ties to the lowest shard, as
    ``jnp.argmax``), then win * vl + its local id."""
    win = z_all.argmax(0)
    local = idx_all.gather(0, win[None].to(torch.int64))[0]
    return (win * vl + local).to(torch.int32)


def w8a8_row_full_partial(x2: torch.Tensor, qw: torch.Tensor, group):
    """This rank's part of a K-sharded per-channel INT8 w8a8 linear with
    each activation row quantized over its whole K: the row is gathered,
    its scale taken over all of it, and this rank's slice of the int8 row
    multiplied with its K rows. Returns ((rows, N) exact integer sums in
    f64, (rows,) f32 row scales). The caller sums the parts over the group
    (in f64 the sum stays exact: |sum| < 2^53) and takes
    ``kernels.w8a8_tail`` of the sum: bit for bit the single-device
    ``w8a8_matmul`` over the whole row."""
    kl = x2.shape[1]
    xq, sx = kernels.quantize_rows(group.all_gather_cat(x2, dim=1))
    xq = xq[:, group.index * kl:(group.index + 1) * kl].contiguous()
    if xq.device.type == "cpu" or _int_mm_takes(xq, qw):
        return torch._int_mm(xq, qw).double(), sx
    return xq.double() @ qw.double(), sx
