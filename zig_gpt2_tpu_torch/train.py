"""Training: the causal-LM loss, AdamW and one train step.

Counterpart of ``zig_gpt2_tpu.train``: mean next-token cross-entropy in
float32 over ``gpt2.forward`` (per-block recompute with ``remat``), and
``torch.optim.AdamW`` with ``optax.adamw``'s defaults and semantics (lr
3e-4, betas (0.9, 0.95), eps 1e-8 added to the bias-corrected sqrt(v),
weight decay 0.1 on every leaf, since optax's has no mask). The tree's
leaf tensors are the optimizer's parameters and are updated in place. It
trains float weights only, as the JAX package does, on the device the
tensors are on.

Over a (data, model) mesh (``mesh=``, the JAX ``make_train_step`` jitted
over sharded inputs): every rank holds the shards of a tree from
``parallel.mesh.prepare_params`` (a float tree padded for tp) and steps
its own leaves with its own AdamW, under the rank's config
(``parallel.mesh.local_config``). Each rank passes the same global (B, T)
batch and runs its data rank's B / dp rows; the model's collectives carry
the tensor-parallel forward and backward (``models.gpt2``), the rank's
vocab slice of the logits is all-gathered over the model group (the
gradient: the rank's slice) and the phantom vocab stays masked, the loss
is the mean over the global batch, and the gradients are averaged over the
data group: each rank's loss term is its rows' share of the global mean,
so the sum of the ranks' gradients is the global mean's. Leaves that every
model rank holds whole stay bit-equal across the ranks: their gradients
are the same on each (under sequence parallelism, where each rank's rows
give a part of them, they are summed over the model group first).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.parallel.mesh import param_rules
from zig_gpt2_tpu_torch.quant.quantize import is_quantized
from zig_gpt2_tpu_torch.weights import Params


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _data_rows(t: Optional[torch.Tensor], mesh) -> Optional[torch.Tensor]:
    """This data rank's B / dp rows of a global batch tensor (B must divide
    by dp: ValueError)."""
    if t is None or mesh is None or mesh.dp == 1:
        return t
    if t.shape[0] % mesh.dp:
        raise ValueError(f"batch of {t.shape[0]} rows not divisible by data-parallel degree "
                         f"{mesh.dp}")
    n = t.shape[0] // mesh.dp
    return t[mesh.data_index * n:(mesh.data_index + 1) * n]


def loss_fn(params: Params, tokens: torch.Tensor, config: GPTConfig,
            mask: Optional[torch.Tensor] = None, remat: bool = False,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy over a (B, T) token batch, in f32.
    ``mask``: optional (B, T-1) validity of each target (padded batches).
    ``remat``: recompute each block's activations in the backward pass.
    ``mesh``: tokens and mask are the global batch; the result is this data
    rank's share of the global mean (its rows' sum over the global count,
    which sums to the mean over the data group)."""
    tokens, mask = _data_rows(tokens, mesh), _data_rows(mask, mesh)
    logits = gpt2.forward(params, tokens[:, :-1], config, remat=remat)
    if config.model_group is not None:  # the rank's vocab slice -> every id
        logits = config.model_group.all_gather_cat(logits, dim=-1)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    if mask is None:
        return nll.mean() if mesh is None else nll.sum() / (nll.numel() * mesh.dp)
    m = mask.to(nll.dtype)
    count = m.sum() if mesh is None else mesh.data.all_reduce(m.sum())
    return (nll * m).sum() / count.clamp(min=1.0)


def make_optimizer(params: Params, learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95) -> torch.optim.AdamW:
    """AdamW over every leaf of a float tree (each set to require grad).
    A quantized tree raises: training takes float weights only."""
    attn = params["blocks"]["attn"]
    if "lm_head" in params or any(is_quantized(p) for p in attn.values()):
        raise ValueError("training takes a float parameter tree, not a quantized one")
    leaves = _leaves(params)
    for t in leaves:
        if not t.is_floating_point():
            raise ValueError(f"training takes float leaves, not {t.dtype}")
        t.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(b1, b2), eps=1e-8,
                             weight_decay=weight_decay)


def _flat_grads(params: Params, rules, keep) -> list:
    """The gradients of the tree's leaves whose placement rule passes
    ``keep``, in tree order."""
    if isinstance(params, dict):
        return [g for k, v in params.items() for g in _flat_grads(v, rules[k], keep)]
    return [params.grad] if keep(rules) and params.grad is not None else []


def _sum_grads(grads: list, group) -> None:
    """Sum ``grads`` over ``group`` in place, in one collective."""
    if group.size == 1 or not grads:
        return
    flat = group.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def train_step(params: Params, opt: torch.optim.Optimizer, tokens: torch.Tensor,
               config: GPTConfig, remat: bool = False, mesh=None
               ) -> Tuple[Params, torch.optim.Optimizer, torch.Tensor]:
    """One step: the loss and its gradients, then one optimizer update of
    the tree's leaves in place. Returns (params, opt, loss). ``mesh``: the
    rank's shards and config, the global batch (module docstring); the loss
    returned is the global mean, the same on every rank."""
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = loss_fn(params, tokens, config, remat=remat, mesh=mesh)
        loss.backward()
    if mesh is not None:
        rules = param_rules(params)
        if gpt2._seq_parallel(config):  # whole on every model rank: each row's part
            _sum_grads(_flat_grads(params, rules, lambda r: r[1] is None), mesh.model)
        _sum_grads(_flat_grads(params, rules, lambda r: True), mesh.data)
        loss = mesh.data.all_reduce(loss.detach())
    opt.step()
    return params, opt, loss.detach()


def make_train_step(config: GPTConfig, remat: bool = False, mesh=None):
    """``train_step`` bound to ``config``, ``remat`` and ``mesh``: (params,
    opt, tokens) -> (params, opt, loss)."""
    return functools.partial(train_step, config=config, remat=remat, mesh=mesh)
