#!/usr/bin/env python3
"""Geometry sweep of the float GEMV ``wmm`` on one card: the device time per
call of each K split the kernel takes, at GPT-2 124M's decode shapes, beside
``torch.matmul`` and two floors, so that ``quant.kernels.wmm_geometry``'s
constants can be checked against the card.

    python3 zig_gpt2_tpu_torch/tools/wmm_sweep.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``zig_gpt2_tpu_torch`` is swept (default:
the one holding this script; its ``wmm_geometry`` must return a
``WmmGeometry`` with ``col_tile``). For each shape (768x768, 768x3072,
3072x768), x and w both f32 or both bf16, and rows 1 and 8, it times the
tree's own geometry and every split of 64 to 768 weight rows (whole 32-row
tiles), added in a thread-block cluster when there are 2 to 16 splits, else
by ticket. The weights rotate over 48 (768x768) or 12 random matrices, so
they come from device memory, not from the 50 MB L2. One line per point:
label, dtype, rows, shape, split_rows, splits, combine (C cluster, T
ticket), blocks, the least of three CUDA-graph readings in us per call, and
``geo`` on the tree's own choice. The floors are an elementwise kernel on
one element and a one-block wmm (K=32, N=64, rows 1) in the same timing.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

SHAPES = (("attn", 768, 768, 48), ("c_fc", 768, 3072, 12), ("c_proj", 3072, 768, 12))
SPLIT_ROWS = (64, 96, 128, 192, 256, 384, 512, 768)


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(here), help="checkout to sweep")
    ap.add_argument("--label", default=None, help="name printed with each line")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    label = args.label or root.name
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("wmm_sweep: no CUDA device", file=sys.stderr)
        return 1
    from zig_gpt2_tpu_torch.quant import kernels as qk
    from zig_gpt2_tpu_torch.tools.kernel_ab import time_us

    if not str(Path(qk.__file__).resolve()).startswith(str(root)):
        print(f"wmm_sweep: imported {qk.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"{label}: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False

    def best(fn, calls):
        return min(time_us(fn, calls, torch) for _ in range(3))

    one = torch.zeros(1, device="cuda")
    print(f"{label} floor elementwise-1 {best(lambda i: one.add_(1), 200):.2f}")
    x1, w1 = torch.randn(1, 32, device="cuda"), torch.randn(32, 64, device="cuda")
    print(f"{label} floor wmm-32x64 {best(lambda i: qk.wmm(x1, w1), 200):.2f}")

    g = torch.Generator(device="cuda").manual_seed(5)
    real = qk.wmm_geometry
    for dtype in (torch.float32, torch.bfloat16):
        dn = "f32" if dtype == torch.float32 else "bf16"
        for name, k, n, layers in SHAPES:
            ws = [(torch.randn(k, n, device="cuda", generator=g) * 0.05).to(dtype)
                  for _ in range(layers)]
            calls = max(2 * layers, 96)
            for rows in (1, 8):
                x = torch.randn(rows, k, device="cuda", generator=g).to(dtype)
                lib = best(lambda i: torch.matmul(x, ws[i % layers]), calls)
                print(f"{label} {dn} r{rows} {name} torch.matmul {lib:.2f}")
                own = real(rows, k, n, dtype, dtype)
                points = [own] + [qk.WmmGeometry(own.row_tile, own.col_tile, -(-k // sr), sr,
                                                 2 <= -(-k // sr) <= 16)
                                  for sr in SPLIT_ROWS if sr <= k and sr != own.split_rows]
                for geo in points:
                    qk.wmm_geometry = lambda *a, geo=geo: geo
                    try:
                        err = (qk.wmm(x, ws[0]) - qk.wmm_plain(x, ws[0])).abs().max().item()
                        us = best(lambda i: qk.wmm(x, ws[i % layers]), calls)
                    finally:
                        qk.wmm_geometry = real
                    blocks = -(-rows // geo.row_tile) * -(-n // geo.col_tile) * geo.splits
                    print(f"{label} {dn} r{rows} {name} s{geo.split_rows} n{geo.splits} "
                          f"{'C' if geo.cluster else 'T' if geo.splits > 1 else '-'} "
                          f"b{blocks} {us:.2f}{' geo' if geo is own else ''}"
                          f"{' BAD' if not err < 1e-3 else ''}", flush=True)
            del ws
    return 0


if __name__ == "__main__":
    sys.exit(main())
