"""The parameter bridge: one set of weights for both packages.

The JAX package keeps its parameters as a nested dict of stacked
``(L, ...)`` arrays with ``(in, out)`` linear weights and separate
``wq``/``wk``/``wv``. The port keeps exactly that tree with torch tensors
as leaves, so ``params_from_numpy(jax.tree.map(np.asarray, params))`` feeds
the port the JAX model's weights and ``params_to_numpy`` goes back.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, device="cpu", dtype=None) -> Params:
    """Nested dict of numpy arrays (any float dtype numpy can hold,
    including ml_dtypes' bfloat16, and the leaves of a quantized tree) ->
    the same tree of torch tensors on ``device``. A given ``dtype`` casts
    the float weights only: the int8 ``qw``/``qw4`` leaves and the f32
    quantization ``scale`` leaves keep their dtype, as both packages store
    them. (A bfloat16 leaf goes through f32, since torch cannot read that
    numpy dtype, and comes back bfloat16.)

    A KV cache crosses the same way, unpacked or packed, with its shapes as
    they are: int8 rows, the f32 ``k_scale`` and ``v_scale`` planes (per
    head, or per head pair (L, B, Hp, S) when packed), the int32 ``length``
    and, for a ring cache, ``start`` (B,) and the 0-d ``wptr``, each in its
    own dtype."""

    def leaf(a, name):
        a = np.asarray(a)
        src_bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a, dtype=np.float32 if src_bf16 else a.dtype))
        keep = str(name).endswith("scale")  # quantization scales and cache planes
        if dtype is not None and t.is_floating_point() and not keep:
            want = dtype
        else:
            want = torch.bfloat16 if src_bf16 else t.dtype
        return t.to(device=device, dtype=want)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return leaf(node, name)

    return walk(tree)


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The port's tree -> numpy (bfloat16 leaves come back as f32 arrays,
    which hold every bfloat16 value exactly)."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, params)
