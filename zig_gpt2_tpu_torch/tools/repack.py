"""Offline quantized-weight repack tool.

The port's counterpart of ``zig_gpt2_tpu.tools.repack``: a raw FP32
checkpoint (the reference's format) -> a quantized ``.npz`` (INT8/INT4
payloads and f32 group scales, the meta ``{"model", "mode"}``), which
``--weights <file>.npz`` serves in either package's CLI (tensor-parallel
too, with ``--mesh``):

    python -m zig_gpt2_tpu_torch.tools.repack \\
        --raw models/124M/raw --model 124M --mode int4 \\
        --out models/124M/int4.npz

It runs on the host (the CPU) by design, as the JAX tool does: the
quantization is an offline step and needs no card. ``--tp N`` pads the
head and vocab axes for N model-parallel ranks first
(``parallel.sharding.pad_for_tp``: a quantized layout cannot be padded
afterwards) and aligns the row-parallel scale groups
(``quantize_params(tp=N)``); the meta then adds ``tp``, ``padded_heads``
and ``padded_vocab_size``, as the JAX tool writes them.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--raw", required=True, help="raw checkpoint dir")
    p.add_argument("--model", default="124M")
    p.add_argument("--mode", default="int8", choices=["int8", "int4"])
    p.add_argument("--group-size", type=int, default=None)
    p.add_argument("--tp", type=int, default=1,
                   help="pad the head and vocab axes and align the quantized layouts for "
                        "this model-parallel degree (the padding cannot be added after "
                        "quantization, so serving e.g. the 25-head 1.5B over a mesh needs it "
                        "baked in here)")
    p.add_argument("--out", required=True, help="output .npz path")
    args = p.parse_args(argv)

    from zig_gpt2_tpu_torch.config import get_config
    from zig_gpt2_tpu_torch.quant.quantize import quantize_params
    from zig_gpt2_tpu_torch.utils import io as zio

    config = get_config(args.model)
    params = zio.load_gpt2_raw(args.raw, config, device="cpu")  # host-only tool
    meta = {"model": args.model, "mode": args.mode}
    if args.tp > 1:
        from zig_gpt2_tpu_torch.parallel.sharding import pad_for_tp

        params, config = pad_for_tp(params, config, args.tp)
        meta.update(tp=args.tp, padded_heads=config.padded_heads,
                    padded_vocab_size=config.padded_vocab_size)
    qparams = quantize_params(params, mode=args.mode, group_size=args.group_size, tp=args.tp)
    zio.save_pytree_npz(qparams, args.out, meta=meta)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"{args.mode}, tp={args.tp})")


if __name__ == "__main__":
    main()
