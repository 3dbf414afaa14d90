"""The port's training step over a (data, model) mesh of CPU ranks (gloo,
``file://`` rendezvous) against the JAX package's ``train.make_train_step``
on the same padded tree on one device (``tests/test_sharding.py``'s
sharded train step holds the JAX mesh run to it). The model: 3 heads of
32 and a vocab of 500, padded for tp=2 to 4 heads (a zero phantom head)
and 512 vocab rows (12 masked ones), so that both paddings train; float
f32, three AdamW steps at lr 1e-3 on one fixed (4, 17) batch.

At 1 x 2 (each data row of the spawn runs it, on its model group), 2 x 2,
and 2 x 2 with sequence parallelism:

- each step's loss (the mean over the global batch) within 1e-5 relative
  of JAX's;
- the step-1 gradients, every leaf gathered whole, within atol 1e-6 +
  rtol 1e-4 of ``jax.grad``'s;
- every leaf after step 3 within atol 1e-5 (a hundredth of lr) + rtol
  1e-4 of JAX's where the step-1 gradient exceeds 1e-5, and the phantom
  head's and phantom vocab rows' weights still exactly zero. AdamW moves
  a leaf by about lr times the sign of its gradient's running mean, so
  where a later gradient is near zero two f32 backward passes that agree
  to 1e-4 part the leaf by a few 1e-6 (2.2e-6 at most, measured on one
  c_proj element), and where a gradient is zero up to roundoff (the key
  bias's, to which softmax is blind) by up to lr per step: those are not
  faults;
- each leaf that every model rank holds whole (LayerNorms, wpe, the
  row-parallel biases) bit-equal across the ranks of a model group.

The gradient check fails when the column-parallel backward all-reduce is
removed (``Collectives.sum_grad`` as the identity, 1 x 2): the largest gap
to ``jax.grad`` measured 2.1e-1 then (in attn.c_proj's bias; every leaf
below a LayerNorm is off, ln_1's weight among them), against 1.4e-7 with
it and the 1e-6 + 1e-4 relative gate.

Four ranks, started once for the module (``torch_tp_worker.spawn_ranks``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tp_ref import port_config, to_port
from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu import train as jtrain
from zig_gpt2_tpu.config import GPTConfig
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu.parallel import sharding as jsh

TP = 2
CFG = GPTConfig(vocab_size=500, context_size=32, n_layers=2, n_heads=3, n_embed=96)
LR, STEPS = 1e-3, 3
CASES = {"1x2": ([1, TP], False), "2x2": ([2, TP], False), "2x2-sp": ([2, TP], True)}
TOL = dict(atol=1e-6, rtol=1e-4)
LEAF_TOL = dict(atol=1e-5, rtol=1e-4)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX {losses, grads, leaves}, the padded config)."""
    tmp = tmp_path_factory.mktemp("tp_train")
    params, cfg = jsh.pad_for_tp(jgpt2.init_params(CFG, jax.random.PRNGKey(1)), CFG, TP)
    cfg = dataclasses.replace(cfg, spmd=False)
    assert (cfg.attn_heads, cfg.vocab_rows) == (4, 512)
    tokens = np.random.default_rng(3).integers(0, CFG.vocab_size, (4, 17)).astype(np.int32)
    torch.save(to_port(params), str(tmp / "tree.pt"))
    cases = [{"name": name, "kind": "train", "params": str(tmp / "tree.pt"), "mesh": mesh,
              "config": port_config(cfg), "seq_parallel": sp, "tokens": tokens, "lr": LR,
              "steps": STEPS, "broken": name == "1x2"}
             for name, (mesh, sp) in CASES.items()]
    join = spawn_ranks(2, TP, cases, tmp)
    grads = jax.grad(jtrain.loss_fn)(params, jnp.asarray(tokens), cfg)
    opt = jtrain.make_optimizer(LR)
    state = opt.init(params)
    step = jtrain.make_train_step(cfg, opt)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, jnp.asarray(tokens))
        losses.append(float(loss))
    ref = {"losses": losses, "grads": jax.tree.map(np.asarray, grads),
           "leaves": jax.tree.map(np.asarray, params)}
    return join(), ref, cfg


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_losses_within_tolerance_of_jax(runs, name):
    ranks, ref, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], ref["losses"], rtol=1e-5)
    assert ref["losses"][-1] < ref["losses"][0]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_gradients_within_tolerance_of_jax(runs, name):
    ranks, ref, _ = runs
    want = dict(_paths(ref["grads"]))
    got = dict(_paths(ranks[0][name]["grads"]))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], **TOL, err_msg=f"{name} {path}")


def test_gradient_check_catches_a_missing_column_parallel_all_reduce(runs):
    """Without the column-parallel input's backward all-reduce, every
    gradient below a LayerNorm is one rank's part: the gate above fails."""
    ranks, ref, _ = runs
    want = dict(_paths(ref["grads"]))
    broken = dict(_paths(ranks[0]["1x2"]["broken_grads"]))
    gap = {p: float(np.abs(g - want[p]).max()) for p, g in broken.items()}
    worst = max(gap, key=gap.get)
    assert gap[worst] > 1e-3, gap
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(broken["/blocks/ln_1/w"], want["/blocks/ln_1/w"], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_leaves_after_three_steps_within_tolerance_of_jax(runs, name):
    ranks, ref, cfg = runs
    want = dict(_paths(ref["leaves"]))
    g1 = dict(_paths(ref["grads"]))
    compared = total = 0
    for path, leaf in _paths(ranks[0][name]["leaves"]):
        sure = np.abs(g1[path]) > 1e-5
        compared, total = compared + sure.sum(), total + sure.size
        np.testing.assert_allclose(leaf[sure], want[path][sure], **LEAF_TOL,
                                   err_msg=f"{name} {path}")
    assert compared > 0.8 * total
    leaves = ranks[0][name]["leaves"]
    hd = cfg.head_dim
    assert not leaves["wte"][CFG.vocab_size:].any()
    for lin in ("wq", "wk", "wv"):
        assert not leaves["blocks"]["attn"][lin]["w"][..., CFG.n_heads * hd:].any()
    assert not leaves["blocks"]["attn"]["c_proj"]["w"][:, CFG.n_heads * hd:].any()


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_bit_equal_across_model_ranks(runs, name):
    ranks, _, _ = runs
    for d in range(2):  # each data row's model group (and both rows at 2 x 2)
        group = [ranks[d * TP + m][name]["replicated"] for m in range(TP)]
        assert set(group[0]) >= {"/blocks/ln_1/w", "/wpe", "/ln_f/b", "/blocks/mlp/c_proj/b"}
        assert all(g == group[0] for g in group[1:])
    if name != "1x2":
        assert ranks[0][name]["replicated"] == ranks[TP][name]["replicated"]
