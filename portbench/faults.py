"""Faults planted in the program's timed path, to show that the check sees
them: each is a context manager that patches the program while a run is
inside it, and restores it on exit.

- ``stale``: a decode step that returns its cache unchanged (every tensor
  of the cache as it was before the step, its lengths among them);
- ``half``: half of the batch left out, its logits taken from the other
  half;
- ``token``: each token the batcher draws altered where it is produced
  (the next id in the vocabulary).

The CPU tests plant them under a nano run (``tests/test_portbench_faults.py``);
``control.py --modes`` plants them on the card at a cell's own size.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _stale(real):
    def stuck(params, cache, tokens, config):
        saved = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}
        cache, logits = real(params, cache, tokens, config)
        cache.update(saved)
        return cache, logits
    return stuck


def _half(real):
    def half(params, cache, tokens, config):
        cache, logits = real(params, cache, tokens, config)
        h = logits.shape[0] // 2
        logits[h:] = logits[:logits.shape[0] - h].clone()
        return cache, logits
    return half


def _token(real):
    def altered(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]
    return altered


def plant(name: str, fam):
    """The context manager that plants fault ``name`` in the program that
    family ``fam`` (``portbench.spec.Family``) builds: in the decode step of
    its ``model_module()``, or in the batcher's draw."""
    from zig_gpt2_tpu_torch.runtime import batcher

    if name == "stale":
        return _patched(fam.program.model_module(), "decode_step", _stale)
    if name == "half":
        return _patched(fam.program.model_module(), "decode_step", _half)
    if name == "token":
        return _patched(batcher, "sample", _token)
    raise ValueError(f"unknown fault {name!r}; choices: {FAULTS}")


FAULTS = ("stale", "half", "token")
