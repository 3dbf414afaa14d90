#!/usr/bin/env python3
"""Device time of the decode-attention kernels, of the dequant GEMV ``qmm``
(weight-only and w8a8 bodies), of the float GEMV ``wmm`` and of the
Gumbel-max sampler of one source tree, on inputs that are the same for every tree, so that two trees
compare.

    python3 zig_gpt2_tpu_torch/tools/kernel_ab.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``zig_gpt2_tpu_torch`` is timed (default:
the one holding this script); an older checkout works as long as its
wrappers take ``start=``. The kernels are built from that tree's sources.
To compare two trees on one card, run them in one session in the order
A, B, B, A. Prints the tree's kernels' register counts (from its ``ptxas
-v`` log), then one JSON line per kernel: the device time per
call by CUDA-graph replay (``--repeats`` readings of ``10 L`` calls
rotating over the L layers), the error against the plain version and a
checksum of the inputs. The inputs are drawn on the card from fixed seeds:
the same torch build gives the same bytes in every tree.

Kernels, at the serving paths' shapes: the unpacked INT8 ring kernel (B=16,
R=1025, 1.5B shapes: 48 layers, 25 heads, bf16 q, 1023 old rows per lane),
the unpacked float ring kernel (124M shapes, f32), and, where the tree has
the packed layout, the packed INT8 ring kernel on the same rows packed in
pairs (13 rows with the phantom head); then each of them at B=1 over the
prefix rows of lane 0 (the engine's shape). ``qmm`` at GPT-2 1.5B's
INT4 block linears (1600x1600 G=32, 1600x6400 G=32, 6400x1600 G=128,
rotating over 48 layers) and its INT8 per-channel lm_head (1600x50257),
bf16 x of 1 and 16 rows (the engine's and the batcher's), with a line per
shape and the sum over one decode step's 289 calls. ``w8a8``: the same for
qmm's w8a8 body at the phantom-padded 1.5B shapes (1600x1664 Q/K/V,
1664x1600, 1600x6400, 6400x1600, rotating over 48 layers of random INT8
weights, and the 1600x50257 lm_head). ``wmm``: the float GEMV at GPT-2
124M's decode linears (768x768 Q/K/V and attn c_proj, 768x3072 c_fc,
3072x768 MLP c_proj), rows 1 and 8, x and w both f32 or both bf16, every
call on another of the step's weights (48 for 768x768, 12 for each MLP
shape: 340 MB in f32, so they come from device memory and not from the 50
MB L2), per shape and per decode step (the 72 calls in served order), with
``torch.matmul`` on the same inputs beside each. ``sampler``: the
Gumbel-max sampler at B=1 and B=16 over V=50257 f32 logits, T=0.8
(``--kernels`` picks any of ``attention``, ``qmm``, ``w8a8``, ``wmm``,
``sampler``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

B, R, N, D = 16, 1025, 1023, 64


def register_report(build_log: str) -> list[tuple[str, str]]:
    """(kernel, ptxas resource line) for each entry function in a ``ptxas
    -v`` log, names demangled by ``c++filt`` where it is installed."""
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "Used" in line and "registers" in line and name:
            out.append((name, line.split(":", 1)[1].strip()))
            name = None
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        out = [(names[i], used) for i, (_, used) in enumerate(out)]
    return out


def ring_lanes(torch):
    """Lane 0 starts at 0, lane 1 at R - 1, the others spread over the ring;
    every lane holds N old rows, so most intervals wrap."""
    starts = [0, R - 1] + [(b * 397) % R for b in range(2, B)]
    return (torch.tensor(starts, dtype=torch.int32, device="cuda"),
            torch.full((B,), N, dtype=torch.int32, device="cuda"))


def int8_inputs(torch, g, L, H, W, dtype):
    """q, the quantized current rows and their scales, the int8 caches and
    their f32 scale planes (the wrappers' order), drawn with ``g``. The
    current rows are quantized here (absmax / 127 per row) rather than by
    the tree, so that every tree sees the same bytes."""
    kc, vc = (torch.randint(-127, 128, (L, B, H, R, W), device="cuda", generator=g,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(L, B, H, R, device="cuda", generator=g) * 0.03 + 0.01
              for _ in range(2))
    rows = []
    for _ in range(2):
        x = torch.randn(B, H, W, device="cuda", generator=g)
        scale = x.abs().amax(-1).clamp(min=1e-12) / 127.0
        rows += [torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8), scale]
    q = torch.randn(B, H, W, device="cuda", generator=g).to(dtype)
    return [q, rows[0], rows[1], rows[2], rows[3], kc, ks, vc, vs]


def packed(args, torch):
    """The same rows in the head-pair layout: a zero phantom head appended
    when the head count is odd; each pair's scale is the larger of its two
    heads' (the rows keep their int8 values, so the math differs from the
    unpacked call's only by the scales)."""
    q, kn, ksn, vn, vsn, kc, ks, vc, vs = args

    def rows(t, axis):  # pad the head axis to even, then fold pairs
        if t.shape[axis] % 2:
            shape = list(t.shape)
            shape[axis] = 1
            t = torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], axis)
        return t

    def fold_rows(t):  # (..., H, W) -> (..., H/2, 2W)
        t = rows(t, -2)
        return t.reshape(*t.shape[:-2], t.shape[-2] // 2, 2 * t.shape[-1]).contiguous()

    def fold_seq(t):  # (..., H, S, W) -> (..., H/2, S, 2W)
        t = rows(t, -3)
        *lead, h, s, w = t.shape
        return t.reshape(*lead, h // 2, 2, s, w).transpose(-3, -2).reshape(
            *lead, h // 2, s, 2 * w).contiguous()

    def pair_scale(t, axis):  # per-head scales (axis < 0) -> the larger of each pair
        t = rows(t, axis)
        shape = list(t.shape)
        shape[axis] = shape[axis] // 2
        shape.insert(len(shape) + axis + 1, 2)  # (..., H/2, 2, ...): the pair axis is ``axis``
        return t.reshape(shape).amax(axis).contiguous()

    return [fold_rows(q), fold_rows(kn), pair_scale(ksn, -1), fold_rows(vn),
            pair_scale(vsn, -1), fold_seq(kc), pair_scale(ks, -2), fold_seq(vc),
            pair_scale(vs, -2)]


def checksum(args, torch) -> float:
    return float(sum(a.double().sum().item() * (i + 1) for i, a in enumerate(args)))


def time_us(fn, calls: int, torch) -> float:
    """Mean device time per call of ``calls`` calls of fn(i), captured in a
    CUDA graph and replayed once."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(here), help="checkout to time")
    ap.add_argument("--label", default=None, help="name printed with each line")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--kernels", default="attention,qmm,w8a8,wmm,sampler",
                    help="comma-separated: attention, qmm, w8a8, wmm, sampler")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    label = args.label or root.name
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from zig_gpt2_tpu_torch.ops import _build
    from zig_gpt2_tpu_torch.ops import attention as att

    if not str(Path(att.__file__).resolve()).startswith(str(root)):
        print(f"kernel_ab: imported {att.__file__}, not from {root}", file=sys.stderr)
        return 1
    _, secs, log = _build.build()
    print(f"{label}: build {secs:.1f} s; kernels' registers:")
    for name, used in register_report(log):
        print(f"  {label}: {name}: {used}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    kinds = set(args.kernels.split(","))
    if "attention" in kinds:
        time_attention(att, label, card, args.repeats, torch)
    if "qmm" in kinds:
        time_qmm(label, card, args.repeats, torch)
    if "w8a8" in kinds:
        time_w8a8(label, card, args.repeats, torch)
    if "wmm" in kinds:
        time_wmm(label, card, args.repeats, torch)
    if "sampler" in kinds:
        time_sampler(label, card, args.repeats, torch)
    return 0


def time_attention(att, label, card, repeats, torch):
    """Each attention case per call, ``repeats`` readings of ``10 L`` calls
    rotating over the L layers: the ring at B=16, then lane 0 of each at
    B=1 over the prefix rows."""
    has_packed = "packed" in inspect.signature(att.decode_attention_quant_deferred).parameters

    start, length = ring_lanes(torch)
    cases = []
    g = torch.Generator(device="cuda").manual_seed(10)
    int8 = int8_inputs(torch, g, 48, 25, D, torch.bfloat16)
    cases.append(("int8 ring, unpacked, H=25, bf16 q", att.decode_attention_quant_deferred,
                  att.decode_attention_quant_deferred_plain, int8, 48, {}))
    if has_packed:
        cases.append(("int8 ring, packed, Hp=13, bf16 q", att.decode_attention_quant_deferred,
                      att.decode_attention_quant_deferred_plain, packed(int8, torch), 48,
                      {"packed": True}))
    g = torch.Generator(device="cuda").manual_seed(11)
    flt = [torch.randn(B, 12, D, device="cuda", generator=g) for _ in range(3)]
    flt += [torch.randn(12, B, 12, R, D, device="cuda", generator=g) for _ in range(2)]
    cases.append(("float ring, unpacked, H=12, f32", att.decode_attention_deferred,
                  att.decode_attention_deferred_plain, flt, 12, {}))
    # B=1, prefix rows, lane 0 of the same inputs (the engine's shape).
    one = [(f"{name.replace(' ring', '')} B=1 prefix", kernel, plain,
            [t[:1].contiguous() if t.dim() <= 3 else t[:, :1].contiguous() for t in ops], L,
            {**kw, "start": None})
           for name, kernel, plain, ops, L, kw in cases]
    cases += one
    for name, kernel, plain, ops, L, kw in cases:
        kw = {"start": start, **kw}
        lanes = length[:ops[0].shape[0]]
        err = (kernel(*ops, lanes, layer=0, **kw).float()
               - plain(*ops, lanes, layer=0, **kw).float()).abs().max().item()
        times = [time_us(lambda i: kernel(*ops, lanes, layer=i % L, **kw), 10 * L, torch)
                 for _ in range(repeats)]
        print(json.dumps({"tree": label, "kernel": name, "B": ops[0].shape[0], "R": R,
                          "old_rows": N,
                          "us": times, "us_median": statistics.median(times),
                          "max_abs_err_vs_plain": err,
                          "input_checksum": checksum(ops, torch), "card": card}))


# (label, K, N, INT4, group size, calls per decode step) at GPT-2 1.5B.
QMM_SHAPES = (("attn 1600x1600 int4", 1600, 1600, True, 32, 4 * 48),
              ("mlp.c_fc 1600x6400 int4", 1600, 6400, True, 32, 48),
              ("mlp.c_proj 6400x1600 int4", 6400, 1600, True, 128, 48),
              ("lm_head 1600x50257 int8", 1600, 50257, False, 1600, 1))


def time_qmm(label, card, repeats, torch):
    """qmm per call at each shape of ``QMM_SHAPES`` and per decode step,
    bf16 x of 1 and 16 rows. Block linears rotate over 48 layers of random
    packed bytes (every byte is a valid INT4 pair) and scales, so that the
    weights come from HBM; the lm_head is one 80 MB weight."""
    from zig_gpt2_tpu_torch.quant import kernels as qk

    step = {}
    for name, k, n, int4, group, calls in QMM_SHAPES:
        L = 48 if calls > 1 else 1
        g = torch.Generator(device="cuda").manual_seed(k + n)
        qw = torch.randint(-128 if int4 else -127, 128, (L, k // 2 if int4 else k, n),
                           device="cuda", generator=g, dtype=torch.int8)
        scale = torch.rand(L, k // group, n, device="cuda", generator=g) * 0.01 + 1e-3
        for rows in (1, 16):
            x = torch.randn(rows, k, device="cuda", generator=g).to(torch.bfloat16)
            err = (qk.qmm(x, qw[0], scale[0], int4=int4)
                   - qk.qmm_plain(x, qw[0], scale[0], int4=int4)).abs().max().item()
            times = [time_us(lambda i: qk.qmm(x, qw[i % L], scale[i % L], int4=int4),
                             max(8 * L, 64), torch) for _ in range(repeats)]
            us = statistics.median(times)
            step[rows] = step.get(rows, 0.0) + calls * us
            print(json.dumps({"tree": label, "kernel": f"qmm {name}", "rows": rows, "us": times,
                              "us_median": us, "max_abs_err_vs_plain": err,
                              "input_checksum": checksum([qw[0], scale[0], x], torch),
                              "card": card}))
        del qw, scale
    for rows, us in step.items():
        print(json.dumps({"tree": label, "kernel": "qmm per 1.5B decode step (289 calls)",
                          "rows": rows, "ms": us / 1e3, "card": card}))



# (label, K, N, calls per decode step) of the w8a8 body at GPT-2 1.5B with
# the phantom head padded in.
W8A8_SHAPES = (("attn.wq/wk/wv 1600x1664", 1600, 1664, 3 * 48),
               ("attn.c_proj 1664x1600", 1664, 1600, 48),
               ("mlp.c_fc 1600x6400", 1600, 6400, 48),
               ("mlp.c_proj 6400x1600", 6400, 1600, 48),
               ("lm_head 1600x50257", 1600, 50257, 1))


def time_w8a8(label, card, repeats, torch):
    """qmm's w8a8 body per call at each shape of ``W8A8_SHAPES`` and per
    decode step, bf16 x of 1 and 16 rows. Block linears rotate over 48
    layers of random INT8 weights and per-channel scales, so that the
    weights come from HBM; the lm_head is one 80 MB weight. The error is
    against the plain version (0 when bit-equal)."""
    from zig_gpt2_tpu_torch.quant import kernels as qk

    step = {}
    for name, k, n, calls in W8A8_SHAPES:
        L = 48 if calls > 1 else 1
        g = torch.Generator(device="cuda").manual_seed(k + n + 1)
        qw = torch.randint(-127, 128, (L, k, n), device="cuda", generator=g, dtype=torch.int8)
        scale = torch.rand(L, 1, n, device="cuda", generator=g) * 0.01 + 1e-3
        for rows in (1, 16):
            x = (torch.randn(rows, k, device="cuda", generator=g) * 3).to(torch.bfloat16)
            err = (qk.qmm(x, qw[0], scale[0], w8a8=True)
                   - qk.qmm_plain(x, qw[0], scale[0], w8a8=True)).abs().max().item()
            times = [time_us(lambda i: qk.qmm(x, qw[i % L], scale[i % L], w8a8=True),
                             max(8 * L, 64), torch) for _ in range(repeats)]
            us = statistics.median(times)
            step[rows] = step.get(rows, 0.0) + calls * us
            print(json.dumps({"tree": label, "kernel": f"qmm w8a8 {name}", "rows": rows,
                              "us": times, "us_median": us, "max_abs_err_vs_plain": err,
                              "input_checksum": checksum([qw[0], scale[0], x], torch),
                              "card": card}))
        del qw, scale
    for rows, us in step.items():
        print(json.dumps({"tree": label, "kernel": "qmm w8a8 per 1.5B decode step (289 calls)",
                          "rows": rows, "ms": us / 1e3, "card": card}))


# (label, K, N, calls per decode step) at GPT-2 124M; a layer's calls in
# served order are wq, wk, wv, attn c_proj, c_fc, MLP c_proj.
WMM_SHAPES = (("attn 768x768", 768, 768, 4 * 12),
              ("mlp.c_fc 768x3072", 768, 3072, 12),
              ("mlp.c_proj 3072x768", 3072, 768, 12))


def time_wmm(label, card, repeats, torch):
    """wmm per call at each shape of ``WMM_SHAPES`` and per decode step (the
    72 calls in served order), rows 1 and 8, f32 and bf16 (x and w alike, as
    served), each call on another of the step's random weights, so that
    they come from device memory. ``torch.matmul`` (cuBLAS; f32 without
    TF32) on the same inputs is printed beside each as ``library``."""
    from zig_gpt2_tpu_torch.quant import kernels as qk

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(124)
    base = {name: torch.randn(calls, k, n, device="cuda", generator=g) * 0.05
            for name, k, n, calls in WMM_SHAPES}
    attn, fc, proj = (name for name, *_ in WMM_SHAPES)
    for dtype in (torch.float32, torch.bfloat16):
        ws = {name: t.to(dtype) for name, t in base.items()}
        for rows in (1, 8):
            xs = {k: torch.randn(rows, k, device="cuda", generator=g).to(dtype)
                  for k in (768, 3072)}
            step = []  # one decode step's calls in served order
            for layer in range(12):
                step += [(xs[768], ws[attn][4 * layer + j]) for j in range(4)]
                step += [(xs[768], ws[fc][layer]), (xs[3072], ws[proj][layer])]
            cases = [(name, [(xs[k], w) for w in ws[name]]) for name, k, _, _ in WMM_SHAPES]
            cases.append(("per 124M decode step (72 calls)", step))
            for name, ops in cases:
                x, w = ops[0]
                err = (qk.wmm(x, w) - qk.wmm_plain(x, w)).abs().max().item()
                calls = max(len(ops), 96) if len(ops) < 72 else 4 * len(ops)
                for kernel, fn in (("wmm", qk.wmm), ("library", torch.matmul)):
                    times = [time_us(lambda i: fn(*ops[i % len(ops)]), calls, torch)
                             for _ in range(repeats)]
                    us = statistics.median(times)
                    if len(ops) == 72:
                        times, us = [t * 72 for t in times], us * 72
                    print(json.dumps({"tree": label, "kernel": f"{kernel} {name}",
                                      "rows": rows, "dtype": str(dtype).split(".")[-1],
                                      "us": times, "us_median": us,
                                      "max_abs_err_vs_plain": err,
                                      "input_checksum": checksum([x, w], torch),
                                      "card": card}))
        del ws


def time_sampler(label, card, repeats, torch):
    """The sampler per call at B=1 and B=16, V=50257 f32 logits, T=0.8,
    without a threshold; the ids are held to the plain version's."""
    from zig_gpt2_tpu_torch.ops import sampling_kernel as sk

    V, T = 50257, 0.8
    for B in (1, 16):
        g = torch.Generator(device="cuda").manual_seed(B)
        logits = torch.randn(B, V, device="cuda", generator=g)
        seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32,
                              generator=g)
        same = bool(torch.equal(sk.sample_categorical(logits, seeds, T),
                                sk.sample_categorical_plain(logits, seeds, T)))
        times = [time_us(lambda i: sk.sample_categorical(logits, seeds, T), 400, torch)
                 for _ in range(repeats)]
        print(json.dumps({"tree": label, "kernel": "sample_categorical", "B": B, "V": V,
                          "us": times, "us_median": statistics.median(times),
                          "ids_equal_plain": same,
                          "input_checksum": checksum([logits, seeds], torch), "card": card}))


if __name__ == "__main__":
    sys.exit(main())
