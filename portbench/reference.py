"""Plain PyTorch GPT-2: the yardstick that decides ``correct``.

One full causal forward in float32 (TF32 off), no kernels, no cache and no
batching, over the raw weights as ``portbench.inputs`` makes them. What the
configuration states about quantization is re-done here from those raw
weights, with a frozen copy of the arithmetic (never the program's tensors):

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

``precision`` puts a lower precision in place of float32, for the control
of the check: ``tf32`` rounds both operands of every product to TF32 (10
mantissa bits, round to nearest even), ``fp8`` rounds every activation
operand of a product to float8 e4m3 (weights stay as dequantized).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0


def _divide(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d as one IEEE division (a 0-d tensor divisor: a Python number is
    taken as a multiply by its reciprocal on the card)."""
    return a / a.new_full((), d)


def fake_quant(w: torch.Tensor, qmax: float, group: int) -> torch.Tensor:
    """(..., K, N) weights -> f32 ``q * s``, absmax over K in groups of ``group``."""
    k, n = w.shape[-2], w.shape[-1]
    g = w.float().reshape(*w.shape[:-2], k // group, group, n)
    s = _divide(torch.clamp(g.abs().amax(-2, keepdim=True), min=1e-12), qmax)
    q = torch.clamp(torch.round(g / s), -qmax, qmax)
    return (q * s).reshape(w.shape)


def fake_quant_kv(x: torch.Tensor, pairs: bool) -> torch.Tensor:
    """(T, H, D) -> f32 INT8 round trip per (position, head) or per
    (position, head pair)."""
    T, H, D = x.shape
    if pairs:
        x = F.pad(x, (0, 0, 0, H % 2)).reshape(T, (H + 1) // 2, 2 * D)
    s = _divide(torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / s), -127, 127) * s
    return q.reshape(T, -1, D)[:, :H] if pairs else q


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return x.float().clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).float()


class Reference:
    def __init__(self, weights: dict, config: dict, precision: Optional[str] = None):
        if precision not in (None, "tf32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = config
        self.precision = precision
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

    # -- products in the chosen precision -------------------------------------

    def _mm(self, a: torch.Tensor, b: torch.Tensor, b_is_weight: bool) -> torch.Tensor:
        if self.precision == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        elif self.precision == "fp8":
            a = round_fp8(a)
            if not b_is_weight:
                b = round_fp8(b)
        return torch.matmul(a, b)

    def _linear(self, x, wb):
        w, bias = wb
        return self._mm(x, w, True) + bias

    def _ln(self, x, wb):
        return F.layer_norm(x, (x.shape[-1],), wb[0], wb[1], self.eps)

    # -- the forward -----------------------------------------------------------

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
