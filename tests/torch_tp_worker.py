"""Ranks of the port's tensor- and data-parallel CPU tests.

Not a test file: ``spawn_ranks`` starts dp * tp processes (spawn), which
join one gloo group at a ``file://`` rendezvous in the test's temporary
directory (no ports, so parallel test workers never collide), build a
``parallel.mesh`` mesh and run a list of cases on the port; each rank
saves its results as ``rank<r>.pt``. The ranks import torch and the port
only (never JAX): the JAX references are computed by the test process.

A case is a dict: ``name``, ``kind`` (``engine``, ``scan``, ``batcher``,
``sample``, ``prefill``, ``train`` or ``cli``), ``env`` (variables set
while it runs), ``mesh`` (optional ``[1, tp]``: run on the 1 x tp mesh of
this rank's model group, every data row at once, inside a dp x tp spawn),
and the kind's inputs.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def _env(settings):
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


def _config(fields):
    from zig_gpt2_tpu_torch.config import GPTConfig

    return GPTConfig(**fields)


def _sampling(kw):
    from zig_gpt2_tpu_torch.config import SamplingConfig

    return SamplingConfig(**kw)


def _teacher_forced(engine, ids, tokens, mesh):
    """(len(tokens) + 1, V) logits of the engine's weights: the prefill of
    ``ids`` at the engine's bucket, then one decode step per token, each
    rank's vocab slice gathered over the model group."""
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.runtime.engine import _bucket

    bucket = _bucket(len(ids), engine.prompt_buckets)
    prompt = torch.zeros((1, bucket), dtype=torch.int32)
    prompt[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    cache, logits = gpt2.prefill(engine.params, engine.new_cache(), prompt,
                                 torch.tensor([len(ids)], dtype=torch.int32), engine.config)
    rows = [logits]
    for t in tokens:
        cache, logits = gpt2.decode_step(engine.params, cache,
                                         torch.tensor([t], dtype=torch.int32), engine.config)
        rows.append(logits)
    return mesh.model.all_gather_cat(torch.cat(rows).float(), dim=-1).numpy()


def _row_mesh(mesh):
    """The 1 x tp mesh of this rank's model group inside a dp x tp mesh:
    a 1 x tp case runs on every data row at once."""
    from zig_gpt2_tpu_torch.parallel.distributed import Collectives
    from zig_gpt2_tpu_torch.parallel.mesh import Mesh

    return Mesh(1, mesh.tp, mesh.model_index, mesh.device, mesh.model,
                Collectives([0], 0, mesh.device))


def _gather_data(t, mesh):
    """A (B / dp, ...) tensor of every data rank, in lane order."""
    return t if mesh.dp == 1 else torch.cat(list(mesh.data.all_gather(t).unbind(0)))


def _run_engine(case, mesh, params):
    from zig_gpt2_tpu_torch.runtime.engine import GenerationMetrics, InferenceEngine

    eng = InferenceEngine(_config(case["config"]), params, device="cpu", mesh=mesh,
                          **case.get("engine", {}))
    out = {"kv_packed": eng.config.kv_packed, "heads": eng.config.attn_heads, "tokens": [],
           "sampled": [], "reused": []}
    for ids in case.get("prefixes", ()):
        eng.register_prefix(ids)
    for ids in case["prompts"]:
        m = GenerationMetrics()
        out["tokens"].append(eng.generate(ids, case["steps"], _sampling({"temperature": 0.0}),
                                          metrics=m))
        out["reused"].append(m.prefix_tokens_reused)
    for kw in case.get("sampled", ()):
        out["sampled"].append(eng.generate(case["prompts"][0], case["steps"], _sampling(kw)))
    if case.get("logits"):
        out["logits"] = _teacher_forced(eng, case["prompts"][0], out["tokens"][0], mesh)
    return out


def _run_scan(case, mesh, params):
    from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(_config(case["config"]), params, device="cpu", mesh=mesh,
                          **case.get("engine", {}))
    return {"tokens": [eng.generate_scan(np.asarray(case["prompts"]), case["lengths"],
                                         case["steps"], _sampling(kw)).tolist()
                       for kw in case["sampling"]]}


def _run_batcher(case, mesh, params):
    from zig_gpt2_tpu_torch.runtime import decode_graph
    from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher

    b = ContinuousBatcher(_config(case["config"]), params, device="cpu", mesh=mesh,
                          sampling=_sampling(case.get("sampling", {"temperature": 0.0})),
                          **case.get("batcher", {}))
    for ids in case.get("prefixes", ()):
        b.register_prefix(ids)
    for ids, budget in case["requests"]:
        b.submit(ids, budget)
    done = b.run()
    m = b.metrics
    return {"tokens": {r.rid: r.generated for r in done}, "ring": b.config.ring_cache,
            "kv_packed": b.config.kv_packed, "op_level": b.config.op_level,
            # a mesh batcher decodes eagerly, and would on a card too
            "decode_graph": {"built": b._graph is not None,
                             "captures": m.decode_graph_captures,
                             "on_card": decode_graph.usable(torch.device("cuda"), mesh,
                                                            b.config)},
            "metrics": {"prefix_hits": m.prefix_hits,
                        "prefill_tokens_saved": m.prefill_tokens_saved,
                        "spec_rounds": m.spec_rounds, "tokens_per_round": m.tokens_per_round,
                        "spec_auto_off_step": m.spec_auto_off_step, "steps": m.steps}}


def _run_sample(case, mesh, params):
    """``sample_manual`` on this rank's vocab slice of ``case["logits"]``
    (B, V), with a generator seeded ``case["seed"]``."""
    from zig_gpt2_tpu_torch.runtime.sampling import sample_manual

    logits = torch.as_tensor(case["logits"])
    vl = logits.shape[-1] // mesh.tp
    local = logits[:, mesh.model_index * vl:(mesh.model_index + 1) * vl].contiguous()
    gen = torch.Generator().manual_seed(case["seed"])
    return {"ids": [sample_manual(local, gen, case["temperature"], case.get("top_k"),
                                  case.get("top_p"), mesh.model).tolist()
                    for _ in range(case.get("draws", 1))]}


def _run_prefill(case, mesh, params):
    """One (B, T) prefill of ``case["tokens"]`` (the global batch; this data
    rank runs its lanes) with and without ``seq_parallel``: each one's
    logits (vocab and lanes gathered), its cache (the rank's own), the
    model group's collectives of each, and whether the two are bit-equal
    on this rank."""
    import dataclasses

    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.parallel.mesh import local_config, prepare_params

    cfg = _config(case["config"])
    local, padded = prepare_params(params, cfg, mesh)
    toks = torch.as_tensor(np.asarray(case["tokens"], np.int32))
    lens = torch.as_tensor(np.asarray(case["lengths"], np.int32))
    n = toks.shape[0] // mesh.dp
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    out = {}
    for name, sp in (("plain", False), ("sp", True)):
        conf = local_config(dataclasses.replace(padded, seq_parallel=sp), mesh)
        before = dict(mesh.model.counts)
        cache = gpt2.init_kv_cache(conf, n, case["rows"], quant=case.get("kv_quant"))
        cache, logits = gpt2.prefill(local, cache, toks[rows], lens[rows], conf)
        out[name] = {"cache": cache, "logits": logits,
                     "collectives": {k: v - before.get(k, 0)
                                     for k, v in mesh.model.counts.items()
                                     if v != before.get(k, 0)}}
    out["bit_equal"] = {key: torch.equal(out["plain"]["cache"][key], out["sp"]["cache"][key])
                        for key in out["sp"]["cache"]}
    out["bit_equal"]["logits"] = torch.equal(out["plain"]["logits"], out["sp"]["logits"])
    for name in ("plain", "sp"):
        out[name]["logits"] = _gather_data(
            mesh.model.all_gather_cat(out[name]["logits"], dim=-1), mesh).numpy()
        out[name]["cache"] = {k: t.numpy() for k, t in out[name]["cache"].items()}
    return out


def _gather_leaves(tree, rules, mesh):
    """Every leaf of a rank's tree whole again (model-split axes gathered)."""
    if isinstance(tree, dict):
        return {k: _gather_leaves(v, rules[k], mesh) for k, v in tree.items()}
    t = tree.detach()
    if rules[1] is not None:
        t = mesh.model.all_gather_cat(t, dim=rules[1])
    return t.numpy()


def _run_train(case, mesh, params):
    """``case["steps"]`` AdamW steps (lr ``case["lr"]``) on the global
    batch ``case["tokens"]`` over the mesh: each step's loss, the step-1
    gradients and the final leaves (gathered whole), and the model-replicated
    leaves' bytes (for the cross-rank check). ``broken``: the step-1
    gradients again with the column-parallel backward all-reduce removed
    (``Collectives.sum_grad`` as the identity)."""
    import dataclasses

    from zig_gpt2_tpu_torch import train
    from zig_gpt2_tpu_torch.parallel.distributed import Collectives
    from zig_gpt2_tpu_torch.parallel.mesh import local_config, param_rules, prepare_params

    from zig_gpt2_tpu_torch.weights import tree_map

    cfg = dataclasses.replace(_config(case["config"]), seq_parallel=case.get("seq_parallel",
                                                                            False))
    # A copy: the rank's unsplit leaves would alias the tree the cases share.
    local, padded = prepare_params(tree_map(torch.clone, params), cfg, mesh)
    conf = local_config(padded, mesh)
    rules = param_rules(local)
    tokens = torch.as_tensor(np.asarray(case["tokens"], np.int32))
    opt = train.make_optimizer(local, learning_rate=case["lr"])
    step = train.make_train_step(conf, mesh=mesh)
    out = {"losses": []}

    def grads(tree):
        if isinstance(tree, dict):
            return {k: grads(v) for k, v in tree.items()}
        return tree.grad.clone()

    for i in range(case["steps"]):
        if i == 0 and case.get("broken"):
            sum_grad = Collectives.sum_grad
            Collectives.sum_grad = lambda self, t: t
            try:
                opt.zero_grad(set_to_none=True)
                with torch.enable_grad():
                    train.loss_fn(local, tokens, conf, mesh=mesh).backward()
            finally:
                Collectives.sum_grad = sum_grad
            out["broken_grads"] = _gather_leaves(grads(local), rules, mesh)
        local, opt, loss = step(local, opt, tokens)
        if i == 0:
            out["grads"] = _gather_leaves(grads(local), rules, mesh)
        out["losses"].append(float(loss))
    out["leaves"] = _gather_leaves(local, rules, mesh)
    out["replicated"] = {}

    def replicated(tree, rule, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                replicated(v, rule[k], f"{path}/{k}")
        elif rule[1] is None:
            out["replicated"][path] = tree.detach().numpy().tobytes()

    replicated(local, rules, "")
    return out


def _run_cli(case, mesh, params):
    """``cli.main(case["argv"])`` as a launcher's rank (RANK and WORLD_SIZE
    set: the CLI joins the group this process already holds and leaves it
    open): rank 0's standard output."""
    import contextlib
    import io
    import sys

    from zig_gpt2_tpu_torch import cli

    buf = io.StringIO()
    saved = sys.stdout, sys.stderr
    try:
        with _env({"RANK": str(mesh.rank), "WORLD_SIZE": str(mesh.dp * mesh.tp)}), \
                contextlib.redirect_stdout(buf):
            cli.main(case["argv"])
    finally:
        sys.stdout, sys.stderr = saved
    return {"out": buf.getvalue()}


RUNNERS = {"engine": _run_engine, "scan": _run_scan, "batcher": _run_batcher,
           "sample": _run_sample, "prefill": _run_prefill, "train": _run_train,
           "cli": _run_cli}


def run_rank(rank: int, dp: int, tp: int, init_method: str, cases_file: str,
             out_dir: str) -> None:
    from zig_gpt2_tpu_torch.parallel import distributed as pdist
    from zig_gpt2_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    pdist.initialize(init_method, dp * tp, rank, init_timeout_s=120)
    try:
        mesh = make_mesh(dp, tp, "cpu")
        cases = torch.load(cases_file, weights_only=False)
        trees = {}
        results = {}
        for case in cases:
            path = case.get("params")
            if path is not None and path not in trees:
                trees[path] = torch.load(path, weights_only=False)
            t0 = time.perf_counter()
            on = _row_mesh(mesh) if case.get("mesh") == [1, tp] and dp > 1 else mesh
            with _env(case.get("env", {})):
                results[case["name"]] = RUNNERS[case["kind"]](case, on, trees.get(path))
            results[case["name"]]["seconds"] = time.perf_counter() - t0
        results["_collectives"] = {"model": dict(mesh.model.counts),
                                   "data": dict(mesh.data.counts)}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        pdist.shutdown()


def spawn_ranks(dp: int, tp: int, cases, tmp_dir):
    """Start ``cases`` on a dp x tp mesh of spawned CPU ranks; returns a
    function that waits for them and returns each rank's results, in rank
    order (the caller computes its references meanwhile)."""
    import torch.multiprocessing as mp

    tmp_dir = str(tmp_dir)
    cases_file = os.path.join(tmp_dir, "cases.pt")
    torch.save(cases, cases_file)
    init = f"file://{os.path.join(tmp_dir, 'rendezvous')}"
    context = mp.start_processes(run_rank, args=(dp, tp, init, cases_file, tmp_dir),
                                 nprocs=dp * tp, join=False, start_method="spawn")

    def join() -> list:
        while not context.join():
            pass
        return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(dp * tp)]

    return join
