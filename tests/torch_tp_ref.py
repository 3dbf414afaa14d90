"""The JAX side of the port's tensor- and data-parallel CPU tests.

Not a test file. The reference for a mesh of the port's ranks is the JAX
engine over the same (data, model) mesh of the conftest's virtual CPU
devices with ``ZG2_STEP_SPMD=1``: decode runs the step-level manual body
(per-shard code, collectives by hand, a w8a8 row quantized over the local
K), prefill the GSPMD program. ``mesh_logits`` reads that engine's
per-step logits: its prefill, then ``gpt2.decode_step`` of the per-shard
config inside one ``shard_map`` per step, teacher-forced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.parallel import mesh as jmesh
from zig_gpt2_tpu.parallel import sharding as jsh
from zig_gpt2_tpu.quant import quantize as jq
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.weights import params_from_numpy


@contextlib.contextmanager
def env(**settings):
    """Environment variables set inside the block (the JAX references read
    ``ZG2_STEP_SPMD`` and ``ZG2_FUSED_ATTN`` as they build and trace)."""
    old = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_config(cfg) -> dict:
    """The port's GPTConfig fields of a JAX config, as a dict (ranks build
    the config from it)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.GPTConfig)
            if hasattr(cfg, f.name)}


def tree(cfg, mode, tp, seed=0, scale=3.0, group_size=None):
    """(JAX tree, its padded config): random weights (x ``scale``, so that
    greedy streams vary), padded for tp and quantized for it (``mode``
    int8/int4, or None for float)."""
    params = jax.tree.map(lambda a: a * scale, jgpt2.init_params(cfg, jax.random.PRNGKey(seed)))
    params, cfg = jsh.pad_for_tp(params, cfg, tp)
    cfg = dataclasses.replace(cfg, spmd=False)
    if mode is not None:
        params = jq.quantize_params(params, mode=mode, group_size=group_size, tp=tp)
    return params, cfg


def to_port(params):
    return params_from_numpy(jax.tree.map(np.asarray, params))


def make_mesh(dp, tp):
    return jmesh.make_mesh(dp, tp, devices=jax.devices()[:dp * tp])


def mesh_logits(engine, ids, tokens) -> np.ndarray:
    """(len(tokens) + 1, V) logits of a JAX mesh engine, teacher-forced."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from zig_gpt2_tpu.parallel import step_spmd

    config = engine.config
    lconf = step_spmd.local_config(config)
    pp = step_spmd.step_param_pspecs(config, engine.params)
    cp = jmesh.cache_pspecs(config, quant=engine.kv_quant, data_sharded=True)

    def body(params, cache, token):
        return jgpt2.decode_step(params, cache, token, lconf)

    step = jax.jit(shard_map(body, mesh=config.mesh, in_specs=(pp, cp, P(jmesh.DATA_AXIS)),
                             out_specs=(cp, P(jmesh.DATA_AXIS, jmesh.MODEL_AXIS)),
                             check_vma=False))
    bucket = min(b for b in engine.prompt_buckets if b >= len(ids))
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(ids)] = ids
    cache, logits = engine._prefill(engine.params, engine.new_cache(),
                                    engine._put_data(jnp.asarray(toks)),
                                    engine._put_data(jnp.asarray([len(ids)], jnp.int32)))
    rows = [np.asarray(logits, np.float32)]
    for t in tokens:
        cache, logits = step(engine.params, cache,
                             engine._put_data(jnp.asarray([t], jnp.int32)))
        rows.append(np.asarray(logits, np.float32))
    return np.concatenate(rows)


def first_divergence(a, b):
    """Index of the first differing token of two streams, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))
