"""The port's training step (CPU) against the JAX package's ``train.py``
and ``optax.adamw``.

Tolerances: the loss within 1e-5 relative (the same f32 forward and
log-softmax summed in another order); gradients within atol 1e-6 + rtol
1e-4 of jax.grad's; one AdamW step within 1e-6 + 1e-4 relative of the
optax update, compared where |g| > 1e-6: at step 1 the update is about
lr * sign(g), so a near-zero gradient whose sign differs between the two
backward passes is not a fault. Recompute (``remat=True``) repeats the
same f32 operations, so its loss and gradients equal the stored pass's
bit for bit on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from zig_gpt2_tpu import train as jtrain
from zig_gpt2_tpu.config import GPT2_NANO
from zig_gpt2_tpu.models import gpt2 as jgpt2
from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch import train as ttrain
from zig_gpt2_tpu_torch.models import gpt2 as tgpt2
from zig_gpt2_tpu_torch.quant import quantize as tq
from zig_gpt2_tpu_torch.weights import params_from_numpy

TCFG = tconfig.GPT2_NANO
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


@pytest.fixture(scope="module")
def jparams():
    return jgpt2.init_params(GPT2_NANO, jax.random.PRNGKey(0))


def _tparams(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, GPT2_NANO.vocab_size, (2, 17)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32)
    return toks, mask


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_loss_matches_jax(jparams, batch, masked):
    toks, mask = batch
    want = float(jtrain.loss_fn(jparams, jnp.asarray(toks), GPT2_NANO,
                                mask=jnp.asarray(mask) if masked else None))
    got = ttrain.loss_fn(_tparams(jparams), torch.from_numpy(toks), TCFG,
                         mask=torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.float32 and math.isclose(float(got), want, rel_tol=1e-5)


def test_gradients_match_jax_grad(jparams, batch):
    toks, mask = batch
    jg = jax.grad(jtrain.loss_fn)(jparams, jnp.asarray(toks), GPT2_NANO, mask=jnp.asarray(mask))
    tp = _tparams(jparams)
    ttrain.make_optimizer(tp)  # every leaf requires grad
    ttrain.loss_fn(tp, torch.from_numpy(toks), TCFG, mask=torch.from_numpy(mask)).backward()
    n = 0
    for path, leaf in _paths(tp):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(_at(jg, path)), **GRAD_TOL,
                                   err_msg="/".join(path))
        n += 1
    assert n == 20  # wte, wpe, ln_f (2) and 16 stacked block leaves


def test_one_adamw_step_matches_optax(jparams, batch):
    toks, _ = batch
    opt = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    jg = jax.grad(jtrain.loss_fn)(jparams, jnp.asarray(toks), GPT2_NANO)
    updates, _ = opt.update(jg, opt.init(jparams), jparams)
    want = optax.apply_updates(jparams, updates)
    tp = _tparams(jparams)
    tp, _, _ = ttrain.train_step(tp, ttrain.make_optimizer(tp), torch.from_numpy(toks), TCFG)
    compared = 0
    for path, leaf in _paths(tp):
        g = np.abs(np.asarray(_at(jg, path)))
        sure = g > 1e-6
        got, exp = leaf.detach().numpy(), np.asarray(_at(want, path))
        np.testing.assert_allclose(got[sure], exp[sure], atol=1e-6, rtol=1e-4,
                                   err_msg="/".join(path))
        compared += int(sure.sum())
    assert compared > 0.9 * sum(np.asarray(x).size for x in jax.tree.leaves(jparams))


def test_three_steps_losses_match_jax(jparams, batch):
    """Three steps of the JAX package's train_step (optax state carried)
    and of the port's (make_train_step): the same losses, falling."""
    toks, _ = batch
    opt = jtrain.make_optimizer()
    jp, state, want = jparams, opt.init(jparams), []
    for _ in range(3):
        jp, state, loss = jtrain.train_step(jp, state, jnp.asarray(toks), GPT2_NANO, opt)
        want.append(float(loss))
    tp = _tparams(jparams)
    topt = ttrain.make_optimizer(tp)
    step = ttrain.make_train_step(TCFG)
    got = []
    for _ in range(3):
        tp, topt, loss = step(tp, topt, torch.from_numpy(toks))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] > got[1] > got[2]


def test_remat_matches_stored_activations(jparams, batch):
    toks, mask = batch
    out = []
    for remat in (False, True):
        tp = _tparams(jparams)
        ttrain.make_optimizer(tp)
        loss = ttrain.loss_fn(tp, torch.from_numpy(toks), TCFG, mask=torch.from_numpy(mask),
                              remat=remat)
        loss.backward()
        out.append((loss.item(), [leaf.grad.clone() for _, leaf in _paths(tp)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    jloss = jtrain.loss_fn(jparams, jnp.asarray(toks), GPT2_NANO, mask=jnp.asarray(mask),
                           remat=True)
    assert math.isclose(out[1][0], float(jloss), rel_tol=1e-5)


def test_serving_builds_no_graph_and_quantized_trees_refused(jparams, batch):
    """forward follows the caller's grad mode; prefill and decode never
    record a graph, even on leaves that require grad; a quantized tree
    has no optimizer."""
    toks, _ = batch
    tp = _tparams(jparams)
    ttrain.make_optimizer(tp)
    t = torch.from_numpy(toks)
    assert tgpt2.forward(tp, t, TCFG).requires_grad
    with torch.no_grad():
        assert not tgpt2.forward(tp, t, TCFG).requires_grad
    cache, logits = tgpt2.prefill(tp, tgpt2.init_kv_cache(TCFG, 2, 32), t[:, :4],
                                  torch.tensor([4, 4]), TCFG)
    assert not logits.requires_grad
    assert not tgpt2.decode_step(tp, cache, t[:, 4], TCFG)[1].requires_grad
    with pytest.raises(ValueError, match="quantized"):
        ttrain.make_optimizer(tq.quantize_params(_tparams(jparams), "int8"))
