"""GPT-2 as the yardstick knows it: its weights, its plain reference and its
arithmetic. Plain: torch, math, typing and the harness's shared arithmetic,
never the program.

Weights: GPT-2's initialization (N(0, ``initializer_range``) for every
weight and both embeddings, the residual projections scaled by
1/sqrt(2 L); LayerNorm gains 1, biases 0), one draw per stacked leaf from
a generator on the device, in the dtype the configuration serves
(``weight_dtype``). The tree has the program's layout: linears (in, out),
every block leaf stacked on a leading layer axis, Q/K/V apart.

The reference: one full causal forward in float32 (TF32 off), no kernels,
no cache and no batching, over the raw weights, converted to float32 once
as it is built. What the configuration states about quantization is re-done
here from those raw weights, with the harness's frozen copy of the
arithmetic (``portbench.reference``; never the program's tensors):

- weights ``int4``: every block linear quantized symmetric absmax over K in
  groups of ``int4_group[K]`` rows, ``q = clamp(round(w / s), -7, 7)`` with
  ``s = max(absmax, 1e-12) / 7`` (one IEEE division), used as ``q * s``;
- ``lm_head: int8``: wte^T the same way per output column over all of K
  (``/ 127``); ``tied``: wte^T as it is;
- ``kv_cache: int8``: each position's K and V rows quantized per head, or
  per pair of adjacent heads (``kv_scale: head_pair``; an odd last head is
  paired with a zero head), ``/ 127`` the same way. A served position that
  was prefilled attends over the float K/V of its prompt, as a prefill
  does; every later position (a decode step, or a suffix extended after a
  cached prefix) attends over the quantized rows, its own included. The
  forward takes that boundary as ``float_rows``.

``precision`` puts a lower precision in place of float32 for the control
of the check (``portbench.reference.matmul``).
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference import check_precision, fake_quant, fake_quant_kv, matmul
from portbench.roofline import ACT_BYTES, HBM_BYTES_PER_S, PEAK_OPS_PER_S, least_seconds
from portbench.traffic import seed_words

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def context_rows(config: dict) -> int:
    return config["n_positions"]


# -- weights --------------------------------------------------------------------


def make_weights(config: dict, seed: int, device) -> dict:
    L, E = config["n_layer"], config["n_embd"]
    V, P = config["vocab_size"], config["n_positions"]
    dtype = _DTYPES[config["weight_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed)[0])

    std0 = config["initializer_range"]

    def normal(shape, std=std0):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(std).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, device=device, dtype=dtype)

    proj = std0 / (2.0 * L) ** 0.5

    def linear(k, n, std=std0):
        return {"w": normal((L, k, n), std), "b": const(0.0, L, n)}

    return {
        "wte": normal((V, E)),
        "wpe": normal((P, E)),
        "blocks": {
            "ln_1": {"w": const(1.0, L, E), "b": const(0.0, L, E)},
            "attn": {"wq": linear(E, E), "wk": linear(E, E), "wv": linear(E, E),
                     "c_proj": linear(E, E, proj)},
            "ln_2": {"w": const(1.0, L, E), "b": const(0.0, L, E)},
            "mlp": {"c_fc": linear(E, 4 * E), "c_proj": linear(4 * E, E, proj)},
        },
        "ln_f": {"w": const(1.0, E), "b": const(0.0, E)},
    }


# -- the reference --------------------------------------------------------------


class Reference:
    def __init__(self, weights: dict, config: dict, precision: Optional[str] = None):
        self.precision = check_precision(precision)
        self.cfg = config
        self.heads = config["n_head"]
        self.eps = config["layer_norm_epsilon"]
        self.int8_kv = config["kv_cache"] == "int8"
        self.pairs = config.get("kv_scale") == "head_pair"
        int4 = config["weights"] == "int4"
        groups = {int(k): g for k, g in config.get("int4_group", {}).items()}

        def f32(t):
            return t.float()

        def linear(p, layer):
            w = p["w"][layer]
            w = fake_quant(w, 7.0, groups[w.shape[0]]) if int4 else f32(w)
            return w, f32(p["b"][layer])

        b = weights["blocks"]
        self.layers = []
        for i in range(config["n_layer"]):
            self.layers.append({
                "ln_1": (f32(b["ln_1"]["w"][i]), f32(b["ln_1"]["b"][i])),
                "ln_2": (f32(b["ln_2"]["w"][i]), f32(b["ln_2"]["b"][i])),
                **{name: linear(b["attn"][name], i) for name in ("wq", "wk", "wv")},
                "attn_proj": linear(b["attn"]["c_proj"], i),
                "c_fc": linear(b["mlp"]["c_fc"], i),
                "mlp_proj": linear(b["mlp"]["c_proj"], i),
            })
        self.wte, self.wpe = f32(weights["wte"]), f32(weights["wpe"])
        self.ln_f = (f32(weights["ln_f"]["w"]), f32(weights["ln_f"]["b"]))
        wt = weights["wte"].T
        if config["lm_head"] == "int8":
            self.head = fake_quant(wt, 127.0, wt.shape[0])
        else:
            self.head = f32(wt)

    def at(self, precision: Optional[str]) -> "Reference":
        """This reference at ``precision``, sharing its float32 weights."""
        other = copy.copy(self)
        other.precision = check_precision(precision)
        return other

    def _mm(self, a: torch.Tensor, b: torch.Tensor, b_is_weight: bool) -> torch.Tensor:
        return matmul(a, b, self.precision, b_is_weight)

    def _linear(self, x, wb):
        w, bias = wb
        return self._mm(x, w, True) + bias

    def _ln(self, x, wb):
        return F.layer_norm(x, (x.shape[-1],), wb[0], wb[1], self.eps)

    def _attention(self, q, k, v, float_rows: int):
        """q, k, v (T, H, D); rows below ``float_rows`` read the float K/V,
        the others the INT8 round trip."""
        T, H, D = q.shape
        q, k, v = (t.transpose(0, 1) for t in (q, k, v))  # (H, T, D)
        causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        pos = torch.arange(T, device=q.device)[:, None]
        scale = 1.0 / math.sqrt(D)

        def attend(kk, vv):
            s = self._mm(q, kk.transpose(-1, -2), False) * scale
            p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
            return self._mm(p, vv, False)

        out = attend(k, v)
        if self.int8_kv and float_rows < T:
            kq, vq = (fake_quant_kv(t.transpose(0, 1), self.pairs).transpose(0, 1)
                      for t in (k, v))
            out = torch.where(pos < float_rows, out, attend(kq, vq))
        return out.transpose(0, 1).reshape(T, H * D)

    @torch.no_grad()
    def logits(self, ids: torch.Tensor, float_rows: int, first: int) -> torch.Tensor:
        """(T,) token ids -> (T - first, V) f32 logits at positions [first, T)."""
        T = ids.shape[0]
        x = self.wte[ids] + self.wpe[:T]
        H = self.heads
        for p in self.layers:
            h = self._ln(x, p["ln_1"])
            q, k, v = (self._linear(h, p[n]).reshape(T, H, -1) for n in ("wq", "wk", "wv"))
            x = x + self._linear(self._attention(q, k, v, float_rows), p["attn_proj"])
            h = self._ln(x, p["ln_2"])
            h = F.gelu(self._linear(h, p["c_fc"]), approximate="tanh")
            x = x + self._linear(h, p["mlp_proj"])
        x = self._ln(x[first:], self.ln_f)
        return self._mm(x, self.head, True)


# -- the yardstick's arithmetic -------------------------------------------------


def model_width(config: dict, d: int) -> int:
    """A dimension as the model has it: the packed KV layout pads an odd head
    count with a zero phantom head (1.5B: 25 heads of 64 -> 1664 columns of
    Q/K/V and rows of the attention c_proj); that padding is the program's
    and is no work the inputs need."""
    H, E = config["n_head"], config["n_embd"]
    return E if H % 2 and d == (H + 1) * (E // H) else d


def qmm_call(config: dict, body: str, k: int, n: int, rows: int) -> float:
    """Least seconds of one dequant-GEMV call ``rows`` x (K, N), at the
    model's widths (``model_width``): the weight
    (INT4 packed two to a byte, or INT8), its f32 scales (per group of
    ``int4_group[K]`` rows for INT4, per column for INT8), x in the
    activation dtype and the f32 output; products at the peak of the body
    that runs them (one row or f32 x: the CUDA cores; more bf16 rows: bf16
    tensor cores; the w8a8 body: int8)."""
    act = config["compute_dtype"]
    k, n = model_width(config, k), model_width(config, n)
    if body == "int4":
        groups = k // int(config["int4_group"][str(k)])
        weight = k * n / 2
    else:
        groups, weight = 1, k * n
    nbytes = weight + 4 * groups * n + rows * k * ACT_BYTES[act] + 4 * rows * n
    if body == "w8a8":
        peak = PEAK_OPS_PER_S["int8"]
    elif rows == 1 or act == "float32":
        peak = PEAK_OPS_PER_S["float32"]
    else:
        peak = PEAK_OPS_PER_S["bfloat16"]
    return least_seconds(2.0 * rows * k * n, nbytes, peak)


def kv_row_bytes(config: dict) -> float:
    """Bytes of one position's K and V in one layer's cache, scales included:
    H x D values each, one f32 scale per head or head pair for INT8."""
    H, E = config["n_head"], config["n_embd"]
    if config["kv_cache"] == "int8":
        scales = (H + 1) // 2 if config.get("kv_scale") == "head_pair" else H
        return 2 * (E + 4 * scales)
    return 2 * E * ACT_BYTES[config["compute_dtype"]]


def decode_attention_lane(config: dict, old_rows: int) -> float:
    """Least seconds of one lane's decode attention over all layers: the
    ``old_rows`` cached positions read once, the new row, q in and the
    output out; bound by bytes (a few operations per byte)."""
    E, L = config["n_embd"], config["n_layer"]
    act = ACT_BYTES[config["compute_dtype"]]
    nbytes = L * ((old_rows + 1) * kv_row_bytes(config) + 2 * E * act)
    return nbytes / HBM_BYTES_PER_S


def token_flops(config: dict, attended: int) -> float:
    """Model FLOPs of one token: 2 (12 L E^2 + V E) for the weights, 4 L E
    per attended position for the scores and the values."""
    L, E, V = config["n_layer"], config["n_embd"], config["vocab_size"]
    return 2.0 * (12 * L * E * E + V * E) + 4.0 * L * E * attended


def prompt_flops(config: dict, start: int, n: int) -> float:
    """Model FLOPs of prompt positions [start, n), causal."""
    L, E, V = config["n_layer"], config["n_embd"], config["vocab_size"]
    count = n - start
    attended = (n * (n + 1) - start * (start + 1)) / 2
    return 2.0 * (12 * L * E * E + V * E) * count + 4.0 * L * E * attended
