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
(``Collectives.direct``). A backend that takes a card's tensors for no
reduce-scatter, on the card or through the host, is refused when the
group is made; on the CPU the backend's own error comes at the call.

Training differentiates through the collectives: each has an autograd
form, Megatron's conjugate pairs (the row-parallel output sums forward and
passes the gradient through; the column-parallel input passes forward and
sums the gradient; the gathered logits take the rank's slice of the
gradient; sequence parallelism's reduce-scatter and all-gather are each
other's backward). Outside autograd they are the plain operations.

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

OPS = ("all_reduce", "all_gather", "reduce_scatter")


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


def _grad_mode(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Sum(torch.autograd.Function):
    """The row-parallel output: the sum forward, the gradient as it is."""

    @staticmethod
    def forward(ctx, t, group):
        return group._all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    """The column-parallel input: t as it is forward, the gradient summed."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.group._all_reduce(g), None


class _GatherCat(torch.autograd.Function):
    """Every rank's t concatenated on ``dim``; backward the rank's slice of
    the gradient (``reduce=False``: the gradient is the same on every rank,
    as for the gathered logits) or the reduce-scatter of it (``reduce=True``:
    sequence parallelism, each rank holding a partial gradient)."""

    @staticmethod
    def forward(ctx, t, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce, ctx.n = group, dim, reduce, t.shape[dim]
        return group._all_gather_cat(t, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return ctx.group._reduce_scatter(g, ctx.dim), None, None, None
        return g.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Sequence parallelism's row-parallel output: the sum's slice forward,
    the gradient all-gathered."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return group._reduce_scatter(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group._all_gather_cat(g, ctx.dim), None, None


class Collectives:
    """Sum all-reduce, all-gather and reduce-scatter over one process
    group, on tensors of one device. ``index`` is this rank's place in the
    group's ``ranks``, ``size`` their count; a group of one communicates
    nothing.

    ``counts`` tallies the operations that crossed the wire, by name, and
    ``host_staged`` those of them that were copied through the host
    because the backend takes no tensor of this device for them
    (``direct``, probed at construction on a card's tensors). A backend
    that takes no reduce-scatter there even through the host raises
    RuntimeError here."""

    def __init__(self, ranks: Sequence[int], index: int, device, group=None):
        self.size = len(ranks)
        self.index = index
        self.device = torch.device(device)
        self.group = group
        self.counts: collections.Counter = collections.Counter()
        self.host_staged: collections.Counter = collections.Counter()
        self.direct = {op: True for op in OPS}  # by this device's tensors
        if self.size > 1 and self.device.type != "cpu":
            self.direct = {op: self._probe(op, self.device) for op in OPS}
            if not self.direct["reduce_scatter"] and not self._probe("reduce_scatter",
                                                                    torch.device("cpu")):
                raise RuntimeError("the process group's backend takes no reduce-scatter "
                                   "(sequence parallelism and its backward need one)")

    def _probe(self, op: str, device: torch.device) -> bool:
        """Whether the backend takes a tensor of ``device`` for ``op`` (every
        rank of the group runs the same probes, in the same order)."""
        t = torch.zeros(self.size, device=device)
        try:
            if op == "all_reduce":
                dist.all_reduce(t, group=self.group)
            elif op == "all_gather":
                dist.all_gather([torch.empty_like(t) for _ in range(self.size)], t,
                                group=self.group)
            else:
                dist.reduce_scatter(t[:1].clone(), list(t.chunk(self.size)), group=self.group)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            log.info("%s on %s: not taken by the backend: %s", op, device.type, e)
            return False
        return True

    def _run(self, op: str, t: torch.Tensor, fn) -> torch.Tensor:
        """fn(t), counted as ``op``; through the host where the backend takes
        no tensor of this device for ``op``."""
        self.counts[op] += 1
        if self.direct[op]:
            return fn(t)
        self.host_staged[op] += 1
        return fn(t.cpu()).to(self.device)

    # -- the operations, each with its autograd form --------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in t's dtype (a 16-bit float is summed in
        f32: the backend's 16-bit support varies). t is not modified. Under
        autograd the gradient passes through as it is (a row-parallel
        output, whose gradient every rank holds whole)."""
        if self.size == 1:
            return t
        if _grad_mode(t):
            return _Sum.apply(t, self)
        return self._all_reduce(t)

    def sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """t as it is; under autograd its gradient is summed over the group
        (a column-parallel input: each rank's product gives a part of it)."""
        if self.size == 1 or not _grad_mode(t):
            return t
        return _SumGrad.apply(t, self)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in group order (no autograd
        form: the sampler's and the batcher's bookkeeping)."""
        if self.size == 1:
            return t[None]

        def gather(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.stack(parts)

        return self._run("all_gather", t, gather)

    def all_gather_cat(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's t concatenated along ``dim``, in group order. Under
        autograd the gradient is the rank's slice (every rank holds the same
        gradient of the whole: the gathered logits)."""
        if self.size == 1:
            return t
        if _grad_mode(t):
            return _GatherCat.apply(t, self, dim, False)
        return self._all_gather_cat(t, dim)

    def gather_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``all_gather_cat`` for sequence parallelism: under autograd the
        gradient is reduce-scattered (each rank's column-parallel product
        gives a part of the whole gradient)."""
        if self.size == 1:
            return t
        if _grad_mode(t):
            return _GatherCat.apply(t, self, dim, True)
        return self._all_gather_cat(t, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` (of size / group size) of the sum
        over the group, in t's dtype (a 16-bit float summed in f32, as
        ``all_reduce``). At two ranks each element is one sum of two, so
        the bits equal ``all_reduce``'s in any order. Under autograd the
        gradient is all-gathered."""
        if self.size == 1:
            return t
        if _grad_mode(t):
            return _ReduceScatter.apply(t, self, dim)
        return self._reduce_scatter(t, dim)

    # -- the plain operations ----------------------------------------------

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        half = t.dtype in (torch.bfloat16, torch.float16)

        def reduce(x):
            x = x.float() if half else x.clone()
            dist.all_reduce(x, group=self.group)
            return x

        out = self._run("all_reduce", t, reduce)
        return out.to(t.dtype) if half else out

    def _all_gather_cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(list(self.all_gather(t).unbind(0)), dim=dim)

    def _reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"reduce-scatter of {n} along dim {dim} over {self.size} ranks")
        half = t.dtype in (torch.bfloat16, torch.float16)

        def scatter(x):
            x = x.float() if half else x
            parts = [c.contiguous() for c in x.chunk(self.size, dim)]
            out = torch.empty_like(parts[self.index])
            dist.reduce_scatter(out, parts, group=self.group)
            return out

        out = self._run("reduce_scatter", t, scatter)
        return out.to(t.dtype) if half else out
