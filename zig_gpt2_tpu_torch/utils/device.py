"""The port's device rule, shared by the runtimes and ``parallel.mesh``.

A runtime or a mesh runs on the card unless the caller asks for the CPU
(``device="cpu"``); asking for the card where there is none raises
RuntimeError rather than falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``: RuntimeError for ``cuda`` without a
    card, ValueError for anything but ``cuda`` and ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def device_key(dev: torch.device) -> tuple:
    """(type, index) of ``dev``, with a bare ``cuda`` read as the current
    card, so that two names of one device compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return dev.type, torch.cuda.current_device()
    return dev.type, dev.index
