"""PyTorch golden oracle: a numpy-in, numpy-out GPT-2 forward.

The port's own copy of ``zig_gpt2_tpu.tools.oracle``, over the port's
config: plain PyTorch ops (``F.layer_norm``, ``F.gelu``, masked softmax
attention) on the stacked parameter tree with numpy leaves, used to
check full-model logits and by ``tools.generate_test_data``. It is a
reference written independently of ``models/gpt2.py`` and runs on the
CPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from zig_gpt2_tpu_torch.config import GPTConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """PyTorch's tanh-approx GELU — algebraically equal to the reference's
    formula (ops.zig:224 vs generate_test_data.py:39, SURVEY.md C7)."""
    return F.gelu(x, approximate="tanh")


def attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Full-sequence masked SDPA (the oracle for both the prefill path and,
    step-by-step, the KV-cached decode path — the key equivalence test,
    tests.zig:316-333)."""
    head_dim = q.shape[-1]
    scores = q @ k.transpose(-2, -1) / math.sqrt(head_dim)
    if causal:
        T_q, T_k = scores.shape[-2], scores.shape[-1]
        mask = torch.tril(torch.ones(T_q, T_k, dtype=torch.bool), diagonal=T_k - T_q)
        scores = scores.masked_fill(~mask, float("-inf"))
    return F.softmax(scores, dim=-1) @ v


def block_forward(x: torch.Tensor, bp: Dict[str, Any], i: int, config: GPTConfig):
    """One transformer block from the stacked pytree, layer index ``i``."""
    def lin(p, h):
        return h @ _t(p["w"][i]) + _t(p["b"][i])

    def ln(p, h):
        return F.layer_norm(h, (config.n_embed,), _t(p["w"][i]), _t(p["b"][i]), eps=config.layer_norm_eps)

    B, T, E = x.shape
    H, D = config.attn_heads, config.head_dim
    h = ln(bp["ln_1"], x)
    q = lin(bp["attn"]["wq"], h)
    k = lin(bp["attn"]["wk"], h)
    v = lin(bp["attn"]["wv"], h)
    q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in (q, k, v))
    a = attention(q, k, v).transpose(1, 2).reshape(B, T, E)
    x = x + lin(bp["attn"]["c_proj"], a)
    h = ln(bp["ln_2"], x)
    x = x + lin(bp["mlp"]["c_proj"], gelu(lin(bp["mlp"]["c_fc"], h)))
    return x


@torch.no_grad()
def forward(params: Dict[str, Any], tokens: np.ndarray, config: GPTConfig) -> np.ndarray:
    """Full-sequence logits: (B, T) int tokens -> (B, T, vocab) float32."""
    params = {k: v for k, v in params.items()}  # shallow; leaves are np arrays
    tokens_t = torch.from_numpy(np.asarray(tokens, dtype=np.int64))
    wte, wpe = _t(params["wte"]), _t(params["wpe"])
    T = tokens_t.shape[1]
    x = wte[tokens_t] + wpe[:T][None]
    for i in range(config.n_layers):
        x = block_forward(x, params["blocks"], i, config)
    x = F.layer_norm(
        x, (config.n_embed,), _t(params["ln_f"]["w"]), _t(params["ln_f"]["b"]),
        eps=config.layer_norm_eps,
    )
    logits = x @ wte.T  # tied lm_head, no bias (main.zig:312)
    return logits.numpy()
