"""Ranks of the port's tensor- and data-parallel CPU tests.

Not a test file: ``spawn_ranks`` starts dp * tp processes (spawn), which
join one gloo group at a ``file://`` rendezvous in the test's temporary
directory (no ports, so parallel test workers never collide), build a
``parallel.mesh`` mesh and run a list of cases on the port; each rank
saves its results as ``rank<r>.pt``. The ranks import torch and the port
only (never JAX): the JAX references are computed by the test process.

A case is a dict: ``name``, ``kind`` (``engine``, ``scan``, ``batcher`` or
``sample``), ``env`` (variables set while it runs), and the kind's inputs.
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


def _run_engine(case, mesh, params):
    from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(_config(case["config"]), params, device="cpu", mesh=mesh,
                          **case.get("engine", {}))
    out = {"kv_packed": eng.config.kv_packed, "heads": eng.config.attn_heads, "tokens": [],
           "sampled": []}
    for ids in case["prompts"]:
        out["tokens"].append(eng.generate(ids, case["steps"], _sampling({"temperature": 0.0})))
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
    from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher

    b = ContinuousBatcher(_config(case["config"]), params, device="cpu", mesh=mesh,
                          sampling=_sampling(case.get("sampling", {"temperature": 0.0})),
                          **case.get("batcher", {}))
    for ids, budget in case["requests"]:
        b.submit(ids, budget)
    done = b.run()
    return {"tokens": {r.rid: r.generated for r in done}, "ring": b.config.ring_cache,
            "kv_packed": b.config.kv_packed}


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


RUNNERS = {"engine": _run_engine, "scan": _run_scan, "batcher": _run_batcher,
           "sample": _run_sample}


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
            with _env(case.get("env", {})):
                results[case["name"]] = RUNNERS[case["kind"]](case, mesh, trees.get(path))
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
