"""Training: the causal-LM loss, AdamW and one train step.

Counterpart of ``zig_gpt2_tpu.train``: mean next-token cross-entropy in
float32 over ``gpt2.forward`` (per-block recompute with ``remat``), and
``torch.optim.AdamW`` with ``optax.adamw``'s defaults and semantics (lr
3e-4, betas (0.9, 0.95), eps 1e-8 added to the bias-corrected sqrt(v),
weight decay 0.1 on every leaf, since optax's has no mask). The tree's
leaf tensors are the optimizer's parameters and are updated in place. It
trains float weights only, as the JAX package does, on the device the
tensors are on.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.quant.quantize import is_quantized
from zig_gpt2_tpu_torch.weights import Params


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def loss_fn(params: Params, tokens: torch.Tensor, config: GPTConfig,
            mask: Optional[torch.Tensor] = None, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy over a (B, T) token batch, in f32.
    ``mask``: optional (B, T-1) validity of each target (padded batches).
    ``remat``: recompute each block's activations in the backward pass."""
    logits = gpt2.forward(params, tokens[:, :-1], config, remat=remat)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    if mask is not None:
        m = mask.to(nll.dtype)
        return (nll * m).sum() / m.sum().clamp(min=1.0)
    return nll.mean()


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


def train_step(params: Params, opt: torch.optim.Optimizer, tokens: torch.Tensor,
               config: GPTConfig, remat: bool = False
               ) -> Tuple[Params, torch.optim.Optimizer, torch.Tensor]:
    """One step: the loss and its gradients, then one optimizer update of
    the tree's leaves in place. Returns (params, opt, loss)."""
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = loss_fn(params, tokens, config, remat=remat)
        loss.backward()
    opt.step()
    return params, opt, loss.detach()


def make_train_step(config: GPTConfig, remat: bool = False):
    """``train_step`` bound to ``config`` and ``remat``: (params, opt,
    tokens) -> (params, opt, loss)."""
    return functools.partial(train_step, config=config, remat=remat)
