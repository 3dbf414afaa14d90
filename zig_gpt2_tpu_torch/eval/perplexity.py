"""Token-level perplexity evaluation.

Counterpart of ``zig_gpt2_tpu.eval.perplexity``: the graded quantization
metric (BASELINE.md: WikiText-2 perplexity Δ vs FP32 ≤ 0.1 at INT8 and
w8a8, ≤ 0.5 at INT4). The same windowing: non-overlapping windows of the
stream, the tail window padded and masked, the window count padded to a
multiple of ``batch_size`` with masked rows; log-softmax in float32.

It runs where the parameters are (``params["wte"].device``), under
``torch.inference_mode``, through ``gpt2.forward``: the linears route as
the forward routes them, so on the card a batch of ``batch_size x window
<= 256`` rows runs the ``qmm`` GEMV kernel (w8a8 its s8 x s8 body up to 64
rows), and larger batches the dequantize-then-matmul path.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.models import gpt2


def _chunk_nll(params, tokens: torch.Tensor, mask: torch.Tensor, config: GPTConfig):
    """Summed next-token NLL over a (B, T) window batch: (total_nll,
    total_count), f32 0-d tensors. mask[b, t] marks positions whose
    prediction target tokens[b, t + 1] counts."""
    logits = gpt2.forward(params, tokens, config)  # (B, T, vocab)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    m = mask[:, :-1].float()
    return (nll * m).sum(), m.sum()


def perplexity(params, config: GPTConfig, token_ids: np.ndarray,
               window: Optional[int] = None, batch_size: int = 8) -> float:
    """Perplexity of a token stream under non-overlapping context windows
    (``window`` defaults to the model's context); every token with a
    preceding in-window token is scored."""
    window = window or config.context_size
    ids = np.asarray(token_ids, np.int32)
    if ids.size < 2:
        raise ValueError("need at least 2 tokens to measure perplexity")
    n_chunks = -(-ids.size // window)
    padded = np.zeros((n_chunks, window), np.int32)
    mask = np.zeros((n_chunks, window), np.bool_)
    for i in range(n_chunks):
        part = ids[i * window:(i + 1) * window]
        padded[i, :part.size] = part
        mask[i, :max(part.size - 1, 0)] = True  # position t scores target t + 1
    pad_rows = (-n_chunks) % batch_size  # masked rows are free
    if pad_rows:
        padded = np.concatenate([padded, np.zeros((pad_rows, window), np.int32)])
        mask = np.concatenate([mask, np.zeros((pad_rows, window), np.bool_)])

    device = params["wte"].device
    total_nll, total_cnt = 0.0, 0.0
    with torch.inference_mode():
        for i in range(0, padded.shape[0], batch_size):
            nll, cnt = _chunk_nll(params, torch.from_numpy(padded[i:i + batch_size]).to(device),
                                  torch.from_numpy(mask[i:i + batch_size]).to(device), config)
            total_nll += float(nll)
            total_cnt += float(cnt)
    return math.exp(total_nll / max(total_cnt, 1.0))


def load_tokens(path, encoder=None) -> np.ndarray:
    """An eval corpus: .npy or .bin of int32 token ids, or raw text (needs
    an encoder). WikiText-2's file is ``wiki.test.tokens``."""
    p = Path(path)
    if p.suffix == ".npy":
        return np.load(p).astype(np.int32)
    if p.suffix == ".bin":
        return np.fromfile(p, dtype=np.int32)
    text = p.read_text(encoding="utf-8")
    if encoder is None:
        raise ValueError("raw-text corpus needs a tokenizer")
    return np.asarray(encoder.encode(text), np.int32)


def ppl_gate(params_fp32, params_quant, config: GPTConfig, token_ids: np.ndarray,
             budget: float, **kw) -> Tuple[bool, float, float]:
    """The quantization gate: PPL(quant) - PPL(fp32) <= budget. Returns
    (passed, ppl_fp32, ppl_quant)."""
    p_fp = perplexity(params_fp32, config, token_ids, **kw)
    p_q = perplexity(params_quant, config, token_ids, **kw)
    return (p_q - p_fp) <= budget, p_fp, p_q
