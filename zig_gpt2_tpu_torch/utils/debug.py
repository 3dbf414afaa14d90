"""Numeric-safety debugging.

Counterpart of ``zig_gpt2_tpu.utils.debug``:

- ``nan_checks()``: a context manager that checks the floating outputs of
  every PyTorch op run inside it and raises FloatingPointError at the
  first one holding a NaN or an infinity, naming the op (the
  counterpart of ``jax_debug_nans`` / ``jax_debug_infs``, which point at
  the primitive that made the first NaN). It syncs with the device after
  every op: a debugging tool, not for serving. The model's masks use the
  finite ``ops.layers.MASK_VALUE``, so they do not trip it; the plain
  (CPU) decode attention masks with -inf and does. The hand-written
  kernels are not PyTorch ops: their outputs are checked where the next
  op reads them.
- ``checked_decode_step(config)``: ``gpt2.decode_step`` that first checks
  every lane's cache length lies in [0, max_seq), where a scheduler fault
  would otherwise be clamped silently (one host read per step).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from zig_gpt2_tpu_torch.models import gpt2

# Ops whose outputs are uninitialized memory: their contents mean nothing.
_UNINITIALIZED = ("empty", "new_empty", "empty_like", "empty_strided")


class _NonFiniteCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, t in enumerate(outs):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                bad = ~torch.isfinite(t)
                if bool(bad.any()):
                    kind = "NaN" if bool(torch.isnan(t).any()) else "an infinity"
                    raise FloatingPointError(
                        f"{func}: output {i} holds {kind} ({int(bad.sum())} of {t.numel()} "
                        f"values, shape {tuple(t.shape)}, {t.dtype})")
        return out


@contextlib.contextmanager
def nan_checks(enable: bool = True):
    if not enable:
        yield
        return
    with _NonFiniteCheck():
        yield


def checked_decode_step(config):
    """``gpt2.decode_step`` bound to ``config``, which raises ValueError
    when any lane's ``cache["length"]`` is outside [0, max_seq) (max_seq:
    the cache's rows) instead of letting the write row clamp. Returns
    step(params, cache, tokens) -> (cache, logits)."""

    def step(params, cache, tokens):
        max_seq = cache["k"].shape[-2]
        lengths = cache["length"].tolist()  # one host read
        bad = [(b, n) for b, n in enumerate(lengths) if not 0 <= n < max_seq]
        if bad:
            raise ValueError(f"KV cache length outside [0, {max_seq}): (lane, length) {bad}")
        return gpt2.decode_step(params, cache, tokens, config)

    return step
