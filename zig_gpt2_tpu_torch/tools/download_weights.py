"""GPT-2 weight conversion to the raw checkpoint format (offline only).

The port's copy of the offline parts of
``zig_gpt2_tpu.tools.download_weights``: convert a TF checkpoint or a
HuggingFace ``GPT2LMHeadModel`` (or its state dict) to per-tensor
headerless raw f32 files under ``<out>/raw`` with the ``model-<tfvar with
/ -> ->`` naming, ``*/w`` tensors transposed to (out, in), and write
``byte_encoder.json`` (the byte->unicode table keyed unicode->byte).
``tensorflow`` and ``transformers`` are imported only inside the
converters that need them.

Fetching OpenAI's checkpoint needs the network and is not ported: use
``python -m zig_gpt2_tpu.tools.download_weights --download SIZE --out DIR``
on a machine that has it, then serve ``DIR/raw`` here.

    python -m zig_gpt2_tpu_torch.tools.download_weights --tf-ckpt models/124M/model.ckpt \\
        --out models/124M
    python -m zig_gpt2_tpu_torch.tools.download_weights --hf gpt2 --out models/124M
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

import numpy as np

from zig_gpt2_tpu_torch.tokenizer import bytes_to_unicode
from zig_gpt2_tpu_torch.utils.io import save_tensor


def write_byte_encoder(out_dir: Path) -> None:
    """byte_encoder.json, keyed unicode char -> byte value."""
    table = {ch: b for b, ch in bytes_to_unicode().items()}
    (Path(out_dir) / "byte_encoder.json").write_text(json.dumps(table, ensure_ascii=False))


def _save_raw(out_raw: Path, name: str, arr: np.ndarray, transpose: bool) -> None:
    arr = np.squeeze(np.asarray(arr, np.float32))
    if transpose:
        arr = arr.T  # (in, out) -> (out, in): the reference's column-major
    save_tensor(out_raw / f"model-{name.replace('/', '-')}", arr)


def convert_tf_checkpoint(ckpt_prefix, out_dir) -> int:
    """TF checkpoint -> raw files. Returns the number of tensors written."""
    import tensorflow as tf  # offline tool only

    out_raw = Path(out_dir) / "raw"
    out_raw.mkdir(parents=True, exist_ok=True)
    reader = tf.train.load_checkpoint(str(ckpt_prefix))
    n = 0
    for var in reader.get_variable_to_shape_map():
        name = var.removeprefix("model/")
        _save_raw(out_raw, name, reader.get_tensor(var), transpose=name.endswith("/w"))
        n += 1
    return n


# HF GPT2LMHeadModel state-dict key -> raw name.
_HF_MAP: Dict[str, str] = {
    "transformer.wte.weight": "wte",
    "transformer.wpe.weight": "wpe",
    "transformer.ln_f.weight": "ln_f/g",
    "transformer.ln_f.bias": "ln_f/b",
}
_HF_BLOCK_MAP: Dict[str, str] = {
    "ln_1.weight": "ln_1/g", "ln_1.bias": "ln_1/b",
    "attn.c_attn.weight": "attn/c_attn/w", "attn.c_attn.bias": "attn/c_attn/b",
    "attn.c_proj.weight": "attn/c_proj/w", "attn.c_proj.bias": "attn/c_proj/b",
    "ln_2.weight": "ln_2/g", "ln_2.bias": "ln_2/b",
    "mlp.c_fc.weight": "mlp/c_fc/w", "mlp.c_fc.bias": "mlp/c_fc/b",
    "mlp.c_proj.weight": "mlp/c_proj/w", "mlp.c_proj.bias": "mlp/c_proj/b",
}


def convert_hf_model(model, out_dir) -> int:
    """transformers.GPT2LMHeadModel (or its state_dict) -> raw files. HF's
    Conv1D keeps weights (in, out), as the TF checkpoint does, so ``*/w``
    tensors take the same transpose to (out, in)."""
    out_raw = Path(out_dir) / "raw"
    out_raw.mkdir(parents=True, exist_ok=True)
    state = model if isinstance(model, dict) else model.state_dict()
    n = 0
    for key, tensor in state.items():
        arr = tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else tensor
        if key in _HF_MAP:
            name = _HF_MAP[key]
        elif key.startswith("transformer.h."):
            _, _, idx, rest = key.split(".", 3)
            sub = _HF_BLOCK_MAP.get(rest)
            if sub is None:
                continue  # attn.bias causal-mask buffers etc.
            name = f"h{idx}/{sub}"
        else:
            continue  # lm_head.weight is tied to wte
        _save_raw(out_raw, name, arr, transpose=name.endswith("/w"))
        n += 1
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--download", metavar="SIZE",
                     help="not in the port: fetching needs the network (see above)")
    src.add_argument("--tf-ckpt", metavar="PREFIX", help="local model.ckpt prefix")
    src.add_argument("--hf", metavar="NAME_OR_PATH", help="HF GPT2LMHeadModel")
    p.add_argument("--out", required=True, help="output model dir (raw/ created inside)")
    args = p.parse_args(argv)

    out = Path(args.out)
    if args.download:
        sys.exit("error: --download fetches from the network and is not in the port: run "
                 "python -m zig_gpt2_tpu.tools.download_weights --download "
                 f"{args.download} --out {args.out} where the network is, or convert a "
                 "local checkpoint with --tf-ckpt or --hf")
    if args.tf_ckpt:
        n = convert_tf_checkpoint(args.tf_ckpt, out)
    else:
        from transformers import GPT2LMHeadModel

        n = convert_hf_model(GPT2LMHeadModel.from_pretrained(args.hf), out)
    write_byte_encoder(out)
    print(f"converted {n} tensors -> {out}/raw")


if __name__ == "__main__":
    main()
