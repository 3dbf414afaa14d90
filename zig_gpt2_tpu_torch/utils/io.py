"""Checkpoint IO: raw GPT-2 checkpoints and ``.npz`` parameter trees.

Counterpart of ``zig_gpt2_tpu.utils.io``, in numpy, with torch tensors
made through ``weights.params_from_numpy``:

- ``load_gpt2_raw`` / ``save_gpt2_raw``: the reference's headerless
  format. File names follow the TF variables with '/' -> '-'
  (``model-h{i}-attn-c_attn-w`` ...); '-w' tensors are stored ``(out,
  in)`` and transposed to ``(in, out)`` on load; the packed c_attn is
  split into separate wq/wk/wv.
- ``save_pytree_npz`` / ``load_pytree_npz``: any tree (a quantized one
  too: int8 payloads and f32 scales) as one ``.npz`` whose keys are the
  tree paths joined with '/', with an optional JSON meta dict stored as
  uint8 bytes under ``__zg2_meta__``. The files are the JAX package's:
  either package reads what the other writes, leaf for leaf.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from zig_gpt2_tpu_torch.config import GPTConfig
from zig_gpt2_tpu_torch.weights import Params, params_from_numpy, params_to_numpy, tree_map


def load_tensor(path, shape: Sequence[int], dtype=np.float32) -> np.ndarray:
    """Read a headerless little-endian tensor of known shape."""
    arr = np.memmap(path, dtype=dtype, mode="r")
    n = int(np.prod(shape))
    if arr.size != n:
        raise ValueError(f"{path}: expected {n} elements ({shape}), found {arr.size}")
    return np.asarray(arr).reshape(shape)


def save_tensor(path, arr: np.ndarray) -> None:
    """Write the headerless format: the array's bytes in its own dtype."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.ascontiguousarray(arr).tofile(path)


def _linear(d: Path, name: str, n_in: int, n_out: int) -> Dict[str, np.ndarray]:
    return {"w": np.ascontiguousarray(load_tensor(d / f"model-{name}-w", (n_out, n_in)).T),
            "b": load_tensor(d / f"model-{name}-b", (n_out,))}


def _ln(d: Path, name: str, n: int) -> Dict[str, np.ndarray]:
    return {"w": load_tensor(d / f"model-{name}-g", (n,)),
            "b": load_tensor(d / f"model-{name}-b", (n,))}


def _stack(trees: list) -> Dict[str, np.ndarray]:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}


def load_gpt2_raw(raw_dir, config: GPTConfig, dtype=None, device="cpu") -> Params:
    """Assemble the stacked parameter tree from a raw checkpoint directory
    (lm_head is tied to wte: there is no lm_head file)."""
    d = Path(raw_dir)
    E, L = config.n_embed, config.n_layers

    def qkv(i):
        packed = _linear(d, f"h{i}-attn-c_attn", E, 3 * E)
        return {name: {"w": np.ascontiguousarray(packed["w"][:, j * E:(j + 1) * E]),
                       "b": np.ascontiguousarray(packed["b"][j * E:(j + 1) * E])}
                for j, name in enumerate(("wq", "wk", "wv"))}

    split = [qkv(i) for i in range(L)]
    tree = {
        "wte": load_tensor(d / "model-wte", (config.vocab_size, E)),
        "wpe": load_tensor(d / "model-wpe", (config.context_size, E)),
        "blocks": {
            "ln_1": _stack([_ln(d, f"h{i}-ln_1", E) for i in range(L)]),
            "attn": {
                "wq": _stack([s["wq"] for s in split]),
                "wk": _stack([s["wk"] for s in split]),
                "wv": _stack([s["wv"] for s in split]),
                "c_proj": _stack([_linear(d, f"h{i}-attn-c_proj", E, E) for i in range(L)]),
            },
            "ln_2": _stack([_ln(d, f"h{i}-ln_2", E) for i in range(L)]),
            "mlp": {
                "c_fc": _stack([_linear(d, f"h{i}-mlp-c_fc", E, 4 * E) for i in range(L)]),
                "c_proj": _stack([_linear(d, f"h{i}-mlp-c_proj", 4 * E, E) for i in range(L)]),
            },
        },
        "ln_f": _ln(d, "ln_f", E),
    }
    return params_from_numpy(tree, device=device, dtype=dtype)


def save_gpt2_raw(params: Params, raw_dir, config: GPTConfig) -> None:
    """Export the stacked tree to the raw format (inverse of load_gpt2_raw:
    '-w' tensors back to (out, in), Q/K/V repacked into c_attn)."""
    d = Path(raw_dir)
    d.mkdir(parents=True, exist_ok=True)
    p = tree_map(lambda a: a.astype(np.float32), params_to_numpy(params))
    blocks = p["blocks"]

    def save_linear(name, lp, i):
        save_tensor(d / f"model-{name}-w", lp["w"][i].T)
        save_tensor(d / f"model-{name}-b", lp["b"][i])

    def save_ln(name, lp, i=None):
        save_tensor(d / f"model-{name}-g", lp["w"] if i is None else lp["w"][i])
        save_tensor(d / f"model-{name}-b", lp["b"] if i is None else lp["b"][i])

    save_tensor(d / "model-wte", p["wte"])
    save_tensor(d / "model-wpe", p["wpe"])
    a = blocks["attn"]
    c_attn = {k: np.concatenate([a["wq"][k], a["wk"][k], a["wv"][k]], axis=-1)
              for k in ("w", "b")}
    for i in range(config.n_layers):
        save_ln(f"h{i}-ln_1", blocks["ln_1"], i)
        save_linear(f"h{i}-attn-c_attn", c_attn, i)
        save_linear(f"h{i}-attn-c_proj", a["c_proj"], i)
        save_ln(f"h{i}-ln_2", blocks["ln_2"], i)
        save_linear(f"h{i}-mlp-c_fc", blocks["mlp"]["c_fc"], i)
        save_linear(f"h{i}-mlp-c_proj", blocks["mlp"]["c_proj"], i)
    save_ln("ln_f", p["ln_f"])


# ---------------------------------------------------------------------------
# Parameter trees as .npz (quantized checkpoints: tools/repack.py)
# ---------------------------------------------------------------------------

_NPZ_META_KEY = "__zg2_meta__"


def _leaf_to_numpy(t) -> np.ndarray:
    """A tree leaf as numpy, in the bytes the JAX package writes: a
    bfloat16 tensor as 2-byte void records (numpy has no bfloat16, and
    ``np.savez`` stores ml_dtypes' bfloat16 as ``|V2``)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_pytree_npz(params: Params, path, meta: Optional[dict] = None) -> None:
    """Write ``params`` (torch or numpy leaves; None leaves skipped) to one
    ``.npz``: keys are the '/'-joined tree paths, and ``meta``, a JSON-able
    dict (the repacker records the model and mode), sits under
    ``__zg2_meta__`` as uint8 bytes."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif node is not None:
            flat[prefix] = _leaf_to_numpy(node)

    walk("", params)
    if meta:
        flat[_NPZ_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_pytree_npz(path, device="cuda", with_meta: bool = False):
    """Read a ``.npz`` tree (either package's) onto ``device``, every leaf
    in its stored dtype (int8 payloads, f32 scales and float weights
    alike). Returns the tree, or (tree, meta) with ``with_meta`` (meta None
    when the file has none).

    A 2-byte void leaf (a bfloat16 array that ``np.savez`` stored without
    its dtype) raises TypeError naming the leaf, as the JAX package's
    loader refuses it: its bytes are not handed to a model as numbers.
    Cast such a tree to float32 before saving it."""
    meta: Optional[dict] = None
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            if key == _NPZ_META_KEY:
                meta = json.loads(arr.tobytes().decode("utf-8"))
                continue
            if arr.dtype.kind == "V":
                raise TypeError(f"{path}: leaf {key!r} holds raw {arr.dtype.str} records (a "
                                f"bfloat16 array saved without its dtype), not numbers")
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    params = params_from_numpy(tree, device=device)
    return (params, meta) if with_meta else params
