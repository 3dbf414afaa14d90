"""Gumbel-max categorical sampler: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``zig_gpt2_tpu.ops.sampling_kernel.sample_categorical``:
per row, ``argmax_j(logit_j / T + Gumbel_j)`` over the ids whose logit is
at least the row's threshold, smallest id on ties. The TPU kernel's noise
comes from the TPU's own PRNG, which nothing else reproduces; here it is
Philox4x32-10 keyed by ``(seeds[b], b)`` with the vocab index as counter,
in the kernel (``csrc/sampling.cu``) and in ``sample_categorical_plain``
alike, so the two give identical ids on the same seeds. ``return_max``
also returns each row's winning z* (the vocab-sharded sampler of the JAX
package takes the argmax of z* across shards).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from zig_gpt2_tpu_torch.ops import _build, tallies

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

# Launch geometry of csrc/sampling.cu: blocks of _SAMPLER_THREADS threads,
# each over a contiguous chunk of one row (a multiple of the block's
# threads), about two blocks on each of the H100's 132 SMs.
_SAMPLER_THREADS = 128
_SAMPLER_SLOTS = 2 * 132


def sampler_geometry(B: int, V: int) -> tuple[int, int]:
    """(splits, chunk) of the sampler's launch for (B, V) logits, from the
    shapes alone: the row's ids [s * chunk, (s + 1) * chunk) go to block
    (s, b), the splits cover V with none empty, and B * splits is about
    _SAMPLER_SLOTS (never fewer than one block per row)."""
    if B < 1 or V < 1:
        raise ValueError(f"sampler_geometry: B and V must be positive, got {B, V}")
    want = -(-_SAMPLER_SLOTS // B)
    chunk = -(-V // want)
    chunk = -(-chunk // _SAMPLER_THREADS) * _SAMPLER_THREADS
    return -(-V // chunk), chunk


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * c, for uint32 values
    held in int64 (split in 16-bit halves so nothing overflows int64)."""
    a = m * (c & 0xFFFF)            # < 2^48
    b = m * (c >> 16)               # < 2^48
    t = a + ((b & 0xFFFF) << 16)    # < 2^49
    return (b >> 16) + (t >> 32), t & _M32


def philox_x0(counter: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor):
    """First output word of Philox4x32-10 at counter (counter, 0, 0, 0) and
    key (k0, k1); uint32 values in int64 tensors, broadcast together."""
    c0 = counter
    c1 = c2 = c3 = torch.zeros_like(counter)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0


def gumbel_noise(seeds: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) f32 Gumbel noise exactly as the kernel draws it."""
    dev = seeds.device
    j = torch.arange(vocab, device=dev, dtype=torch.int64)[None, :]
    k0 = (seeds.to(torch.int64) & _M32)[:, None]
    k1 = torch.arange(seeds.shape[0], device=dev, dtype=torch.int64)[:, None]
    bits = philox_x0(j, k0, k1)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def sample_categorical_plain(logits, seeds, temperature: float,
                             thresh: Optional[torch.Tensor] = None, return_max: bool = False):
    """The kernel's arithmetic in plain PyTorch: (B, V) -> (B,) int32, and
    with ``return_max`` also (B,) f32 z*, the row's largest z."""
    b, v = logits.shape
    x = logits.float()
    inv_t = torch.tensor(np.float32(1.0 / float(temperature)), device=x.device)
    z = x * inv_t + gumbel_noise(seeds, v)
    if thresh is not None:
        z = z.masked_fill(x < thresh.float()[:, None], -float("inf"))
    m = z.amax(-1, keepdim=True)
    ids = torch.arange(v, device=x.device, dtype=torch.int32).expand(b, v)
    out = torch.where(z == m, ids, v).amin(-1).to(torch.int32)
    return (out, m[:, 0]) if return_max else out


@tallies.counted("launches", "max_launches")
def sample_categorical(logits, seeds, temperature: float,
                       thresh: Optional[torch.Tensor] = None, return_max: bool = False):
    """(B, V) logits -> (B,) int32 ids ~ softmax(logits / temperature),
    restricted to ``logits >= thresh`` per row when ``thresh`` (B,) f32 is
    given (how top-k and top-p ride the kernel). seeds: (B,) int32, one
    independent stream per row. With ``return_max`` returns ``(ids, zmax)``,
    zmax (B,) f32 the winning z* = max over kept j of logit_j * (1/T) + g_j;
    the ids do not depend on the flag. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (one launch per call, the vocab split and
    its combine inside it: ``sampler_geometry``) or raises. Launches count in
    ``sample_categorical.launches``, those with ``return_max`` also in
    ``sample_categorical.max_launches``."""
    if logits.device.type == "cpu":
        return sample_categorical_plain(logits, seeds, temperature, thresh, return_max)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_categorical: no kernel for {logits.device}")
    if temperature <= 0:
        raise ValueError("sample_categorical needs temperature > 0 (greedy is argmax)")
    if logits.dim() != 2 or logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"logits must be (B, V) f32/bf16, got {tuple(logits.shape)} "
                         f"{logits.dtype}")
    b, v = logits.shape
    checks = [("seeds", seeds, torch.int32)]
    if thresh is not None:
        checks.append(("thresh", thresh, torch.float32))
    for name, t, dtype in [("logits", logits, logits.dtype)] + checks:
        if t.device != logits.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {logits.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if name != "logits" and tuple(t.shape) != (b,):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected ({b},)")
    if b > 65535:
        raise ValueError(f"sample_categorical takes at most 65535 rows, got {b}")
    splits, chunk = sampler_geometry(b, v)
    dev = logits.device
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    zmax = torch.empty((b,), dtype=torch.float32, device=dev) if return_max else None
    scratch = (None, None, None)
    if splits > 1:  # held until the launch is enqueued
        scratch = (torch.empty((b, splits), dtype=torch.float32, device=dev),
                   torch.empty((b, splits), dtype=torch.int32, device=dev),
                   _build.tickets(dev, b))
    part_z, part_i, tickets = (None if t is None else t.data_ptr() for t in scratch)
    err = _build.library().zg2_sample_categorical(
        logits.data_ptr(), seeds.data_ptr(),
        thresh.data_ptr() if thresh is not None else None, out.data_ptr(),
        zmax.data_ptr() if zmax is not None else None, part_z, part_i, tickets,
        b, v, splits, chunk, float(np.float32(1.0 / float(temperature))),
        _DTYPE_CODES[logits.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sample_categorical")
    sample_categorical.launches += 1
    sample_categorical.max_launches += return_max
    return (out, zmax) if return_max else out

