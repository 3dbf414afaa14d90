"""Process groups and the collectives the tensor-parallel model uses.

The port's counterpart of ``zig_gpt2_tpu.parallel.distributed``. The JAX
package starts ``jax.distributed`` and lets XLA emit the collectives; here
every rank is a process of ``torch.distributed``, and the model calls its
collectives by hand through ``Collectives`` (one per process group).

Failure policy, the JAX package's: a bounded start (a rendezvous that does
not complete within ``init_timeout_s`` raises RuntimeError naming the
address, the world size and the timeout) and fail-stop on a lost peer (a
collective raises after the group's timeout; nothing tries to recover).

The backend is the caller's choice and nothing switches it: ``nccl`` when
each rank has a card of its own, ``gloo`` for the CPU and for several
ranks that share one card (NCCL refuses two ranks on one device). Where
gloo takes no CUDA tensor for an operation, ``Collectives`` copies to the
host and back explicitly and counts it: that is the transport then, not a
fallback. Which operations gloo took directly is probed once per group
(``Collectives.direct``).

The JAX package's XLA overlap flags (``OVERLAP_FLAGS``,
``enable_collective_overlap``, ``ZG2_OVERLAP``) have no counterpart: they
steer XLA's scheduler, which the port does not use.
"""

from __future__ import annotations

import collections
import datetime
import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

OPS = ("all_reduce", "all_gather")


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, init_timeout_s: int = 300,
               backend: str = "gloo") -> bool:
    """Join the process group: ``coordinator_address`` is an init method
    (``tcp://host:port``, ``file:///path``, or ``host:port``), with
    ``num_processes`` and ``process_id``; without an address the
    environment's ``RANK``, ``WORLD_SIZE`` (and ``MASTER_ADDR``,
    ``MASTER_PORT``) are read. A single process (no address, no rank
    environment, at most one process) returns False at once; a joined or
    already initialized group returns True. A rendezvous that does not
    complete within ``init_timeout_s`` raises RuntimeError."""
    env_ranked = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and num_processes in (None, 1) and not env_ranked:
        log.info("single-process run; no process group")
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=init_timeout_s))
    except Exception as e:  # fail-stop with the context, never a hang
        raise RuntimeError(f"distributed initialization failed (address={init_method!r}, "
                           f"world_size={world}, rank={rank}, backend={backend}, "
                           f"timeout={init_timeout_s}s): {e}") from e
    log.info("distributed: rank %d of %d (%s)", rank, world, backend)
    return True


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Collectives:
    """Sum all-reduce and all-gather over one process group, on tensors of
    one device. ``index`` is this rank's place in the group's ``ranks``,
    ``size`` their count; a group of one communicates nothing.

    ``counts`` tallies the operations that crossed the wire, by name, and
    ``host_staged`` those of them that were copied through the host
    because the backend takes no tensor of this device for them
    (``direct``, probed at construction)."""

    def __init__(self, ranks: Sequence[int], index: int, device, group=None):
        self.size = len(ranks)
        self.index = index
        self.device = torch.device(device)
        self.group = group
        self.counts: collections.Counter = collections.Counter()
        self.host_staged: collections.Counter = collections.Counter()
        self.direct = {op: True for op in OPS}
        if self.size > 1 and self.device.type != "cpu":
            self.direct = {op: self._probe(op) for op in OPS}

    def _probe(self, op: str) -> bool:
        """Whether the backend takes a tensor of this device for ``op``
        (every rank of the group runs the same probe, in the same order)."""
        t = torch.zeros(1, device=self.device)
        try:
            if op == "all_reduce":
                dist.all_reduce(t, group=self.group)
            else:
                dist.all_gather([torch.empty_like(t) for _ in range(self.size)], t,
                                group=self.group)
        except (RuntimeError, ValueError) as e:
            log.info("%s on %s is staged through the host: %s", op, self.device.type, e)
            return False
        return True

    def _run(self, op: str, t: torch.Tensor, fn) -> torch.Tensor:
        self.counts[op] += 1
        if self.direct[op]:
            return fn(t)
        self.host_staged[op] += 1
        return fn(t.cpu()).to(self.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in t's dtype (a 16-bit float is summed in
        f32: the backend's 16-bit support varies). t is not modified."""
        if self.size == 1:
            return t
        half = t.dtype in (torch.bfloat16, torch.float16)

        def reduce(x):
            x = x.float() if half else x.clone()
            dist.all_reduce(x, group=self.group)
            return x

        out = self._run("all_reduce", t, reduce)
        return out.to(t.dtype) if half else out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in group order."""
        if self.size == 1:
            return t[None]

        def gather(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.stack(parts)

        return self._run("all_gather", t, gather)

    def all_gather_cat(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's t concatenated along ``dim``, in group order."""
        return torch.cat(list(self.all_gather(t).unbind(0)), dim=dim)
