"""The (data, model) mesh over process ranks, and the Megatron placement.

Counterpart of ``zig_gpt2_tpu.parallel.mesh`` (and of the parameter and
config rules of ``parallel.step_spmd``). The JAX package names a device
mesh and lets XLA place each array by a PartitionSpec; here each rank is a
process that knows its (data, model) coordinate and holds the slices that
coordinate owns, cut out by one table of rules (a rule per leaf: the axis
split over the data ranks and the axis split over the model ranks, or
None):

- column-parallel linears (wq, wk, wv, c_fc) split N, with their scales and
  bias; row-parallel linears (the c_proj pair) split K with their grouped
  scales, while a per-channel scale row (one group spanning K) and the bias
  are replicated (both are applied after the all-reduce);
- the grouped scales of an INT4 row-parallel linear are replicated too (the
  JAX package's step-level exception): the half-split packing gives a rank
  two feature ranges, which ``shard_kernels.int4_row_shard_slices`` cuts
  out of the whole scale array;
- wte splits its vocab rows; an untied lm_head splits its columns; wpe and
  the LayerNorms are replicated;
- the KV cache splits heads (or head pairs, packed) over the model ranks
  and lanes over the data ranks, ring ``start`` over the data ranks, and
  ``wptr`` is replicated.

Rank r sits at data index r // tp, model index r % tp (the JAX mesh's
device order). ``prepare_serving`` is the engine's and the batcher's one
constructor policy: check the batch against dp, pad
(``sharding.pad_for_tp``) and slice, decide the packed layout per shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from zig_gpt2_tpu_torch.config import GPTConfig, RankConfig
from zig_gpt2_tpu_torch.parallel.distributed import Collectives
from zig_gpt2_tpu_torch.parallel.sharding import pad_for_tp
from zig_gpt2_tpu_torch.utils.device import resolve_device

_LINEARS = (("attn", "wq", "col"), ("attn", "wk", "col"), ("attn", "wv", "col"),
            ("attn", "c_proj", "row"), ("mlp", "c_fc", "col"), ("mlp", "c_proj", "row"))


@dataclasses.dataclass
class Mesh:
    """This rank's place in a dp x tp mesh: ``model`` are the collectives
    over the tp ranks that share its data index (the tensor-parallel
    group), ``data`` those over the dp ranks that share its model index."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    model: Collectives
    data: Collectives

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp


def make_mesh(dp: int = 1, tp: int = 1, device="cuda") -> Mesh:
    """This rank's (data, model) mesh over the joined process group
    (``distributed.initialize``), whose size must be dp * tp; a 1 x 1 mesh
    needs no group. Every rank makes the groups, in the same order. The
    mesh's tensors live on ``device``: the card unless the caller asks for
    the CPU (``device="cpu"``), and RuntimeError without a card, the
    engine's rule; the engine and the batcher refuse a mesh on a device
    other than theirs."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {dp}x{tp}: both degrees must be positive")
    device = resolve_device(device)
    if dp * tp == 1:
        return Mesh(1, 1, 0, device, Collectives([0], 0, device), Collectives([0], 0, device))
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {dp}x{tp} needs a process group: call "
                           f"parallel.distributed.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * tp:
        raise ValueError(f"mesh {dp}x{tp} != {world} processes")
    model = data = None
    for d in range(dp):
        ranks = [d * tp + m for m in range(tp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            model = (ranks, group)
    for m in range(tp):
        ranks = [d * tp + m for d in range(dp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            data = (ranks, group)
    return Mesh(dp, tp, rank, device,
                Collectives(model[0], model[0].index(rank), device, model[1]),
                Collectives(data[0], data[0].index(rank), device, data[1]))


# ---------------------------------------------------------------------------
# The placement table
# ---------------------------------------------------------------------------

Rule = Tuple[Optional[int], Optional[int]]  # (data-split axis, model-split axis)
REPLICATED: Rule = (None, None)


def _linear_rules(p: Dict[str, Any], role: str) -> Dict[str, Rule]:
    """Rules of one linear's leaves (float or quantized), stacked (L, K, N)."""
    col = role == "col"
    out = {}
    for name, leaf in p.items():
        if name in ("w", "qw", "qw4"):
            out[name] = (None, -1 if col else -2)
        elif name == "scale":
            per_channel = leaf.shape[-2] == 1
            out[name] = (None, -1) if col else (REPLICATED if per_channel else (None, -2))
        elif name == "b":
            out[name] = (None, -1) if col else REPLICATED
        else:
            raise ValueError(f"unknown linear param leaf {name!r}")
    return out


def param_rules(params: Dict[str, Any]) -> Dict[str, Any]:
    """The Megatron placement of a GPT-2 tree (``param_pspecs``), leaf by
    leaf, for its exact structure (float or quantized, tied or not)."""
    blocks = params["blocks"]
    if "wqkv" in blocks["attn"]:
        raise ValueError("a fused Q/K/V projection cannot be split by heads: fuse on one "
                         "device only")
    ln = {"w": REPLICATED, "b": REPLICATED}
    rules = {
        "wte": (None, 0),
        "wpe": REPLICATED,
        "blocks": {"ln_1": ln, "ln_2": ln, "attn": {}, "mlp": {}},
        "ln_f": ln,
    }
    for mod, name, role in _LINEARS:
        rules["blocks"][mod][name] = _linear_rules(blocks[mod][name], role)
    if "lm_head" in params:
        rules["lm_head"] = {name: (None, -1) for name in params["lm_head"]}
    return rules


def step_param_rules(params: Dict[str, Any]) -> Dict[str, Any]:
    """``param_rules`` with the step-level exception: the grouped scales of
    an INT4 row-parallel linear are replicated."""
    rules = param_rules(params)
    for mod in ("attn", "mlp"):
        p = params["blocks"][mod]["c_proj"]
        if "qw4" in p and p["scale"].shape[-2] != 1:
            rules["blocks"][mod]["c_proj"]["scale"] = REPLICATED
    return rules


def cache_rules(cache: Dict[str, torch.Tensor]) -> Dict[str, Rule]:
    """The KV cache's placement (``cache_pspecs``): rows and scale planes
    (L, B, H or Hp, S[, D]) split lanes over data and heads over model;
    ``length`` and ring ``start`` split over data; ``wptr`` is replicated."""
    rules = {}
    for name in cache:
        if name in ("k", "v", "k_scale", "v_scale"):
            rules[name] = (1, 2)
        elif name in ("length", "start"):
            rules[name] = (0, None)
        elif name == "wptr":
            rules[name] = REPLICATED
        else:
            raise ValueError(f"unknown KV cache leaf {name!r}")
    return rules


def shard(tree, rules, mesh: Mesh, device=None):
    """This rank's slices of ``tree`` by ``rules`` (the same nesting),
    contiguous, on ``device`` (default: where they are)."""
    if isinstance(tree, dict):
        return {k: shard(v, rules[k], mesh, device) for k, v in tree.items()}
    t = tree
    for axis, n, i in ((rules[0], mesh.dp, mesh.data_index),
                       (rules[1], mesh.tp, mesh.model_index)):
        if axis is not None and n > 1:
            size = t.shape[axis]
            if size % n:
                raise ValueError(f"axis of {size} does not split over {n} ranks")
            t = t.narrow(axis, i * (size // n), size // n)
    return t.contiguous().to(device if device is not None else t.device)


def shard_params(params: Dict[str, Any], mesh: Mesh, device=None) -> Dict[str, Any]:
    """This rank's slices of a (padded) parameter tree, by
    ``step_param_rules``."""
    return shard(params, step_param_rules(params), mesh, device)


def local_config(config: GPTConfig, mesh: Mesh) -> GPTConfig:
    """A rank's per-shard config (the JAX ``step_spmd.local_config``):
    a ``RankConfig`` with ``padded_heads`` = attn_heads / tp and the model
    group, which turns the model's collectives on. Activations stay full width between
    blocks; the vocab split shows in the shapes of wte and the lm_head."""
    if config.attn_heads % mesh.tp:
        raise ValueError(f"attn_heads {config.attn_heads} not divisible by tp {mesh.tp}: "
                         f"pad the tree first (parallel.sharding.pad_for_tp)")
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(GPTConfig)}
    fields["padded_heads"] = config.attn_heads // mesh.tp
    return RankConfig(**fields, model_group=mesh.model)


def prepare_params(params: Dict[str, Any], config: GPTConfig, mesh: Mesh,
                   device=None) -> Tuple[Dict[str, Any], GPTConfig]:
    """Pad a tree for the mesh's tp (``sharding.pad_for_tp``: a quantized
    tree that needs padding raises ValueError) and slice this rank's part
    onto ``device``. Returns (local params, padded global config)."""
    params, config = pad_for_tp(params, config, mesh.tp)
    return shard_params(params, mesh, device), config


def prepare_serving(params: Dict[str, Any], config: GPTConfig, mesh: Mesh, batch_size: int,
                    device) -> Tuple[Dict[str, Any], GPTConfig]:
    """The engine's and the batcher's constructor policy under a mesh:
    check that the batch splits over the data ranks (ValueError), pad and
    slice (``prepare_params``), and decide the packed layout per shard
    (``gpt2.default_kv_packed`` with tp: packed at head_dim 64 only where
    the heads per rank are even; no phantom head under a mesh). The fused
    Q/K/V projection stays single-device, as in the JAX package. Returns
    (local params, local config)."""
    from zig_gpt2_tpu_torch.models import gpt2

    if batch_size % mesh.dp:
        raise ValueError(f"batch_size {batch_size} not divisible by data-parallel degree "
                         f"{mesh.dp} (mesh {mesh.dp}x{mesh.tp})")
    params, config = prepare_params(params, config, mesh, device)
    config = dataclasses.replace(config, kv_packed=gpt2.default_kv_packed(config, device,
                                                                           tp=mesh.tp))
    return params, local_config(config, mesh)
