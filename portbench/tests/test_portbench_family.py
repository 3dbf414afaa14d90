"""A configuration enters by new files alone, whatever its architecture: the
tests' own ``renamed`` family (GPT-2 under other key names, written into the
throwaway checkout by ``nano.make``) runs through the whole harness, reads
as the ``gpt2`` family's nano cell does, and a ``model_type`` with no family
is refused with the path that was looked for."""

import json
import re
import time

import pytest
import torch

from portbench import check, roofline, run
from portbench.serve import measure, serve
from portbench.spec import Bench, family
from portbench.tests import nano
from portbench.traffic import Traffic

SEED = 2 ** 31 + 5


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def test_renamed_family_runs_correct(nano_root):
    config = Bench(nano_root).cell("nanor-tiny").config
    assert not set(nano.RENAMED_KEYS) & set(config)
    r = run.run("nanor-tiny", SEED, 1.5, False, device="cpu", root=nano_root,
                t_start=time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"tokens_per_s", "ttft_ms_p95", "itl_ms_p95", "itl_ms_p10",
                                 "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_renamed_family_reads_as_gpt2(nano_root):
    """The same seed's weights, check readings, FLOPs and bounds as the nano
    cell's, over the records of one renamed run."""
    bench = Bench(nano_root)
    ours, theirs = bench.cell("nanor-tiny"), bench.cell("nano-tiny")
    a, b = ours.config, theirs.config
    assert family(a).name == "renamed" and family(b).name == "gpt2"
    wa = dict(_leaves(family(a).model.make_weights(a, SEED, "cpu")))
    wb = dict(_leaves(family(b).model.make_weights(b, SEED, "cpu")))
    assert wa.keys() == wb.keys()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)

    traffic = Traffic(ours.traffic, SEED, a["vocab_size"])
    t0 = time.perf_counter()
    out = serve(a, traffic, SEED, 1.5, "cpu", t0)
    picked = check.sample(out.done, traffic.check, SEED)
    assert picked
    got = check.gaps(a, SEED, picked, torch.device("cpu"), "tf32")
    assert got == check.gaps(b, SEED, picked, torch.device("cpu"), "tf32")
    assert got["logit_gap"] == 0.0 and got["tokens_compared"] > 0
    ea, pa, fa = measure(a, out.done, t0, t0 + 60.0)
    eb, pb, fb = measure(b, out.done, t0, t0 + 60.0)
    assert (ea, pa, fa) == (eb, pb, fb) and fa > 0
    for rows in (12, 300):
        assert roofline.token_flops(a, rows) == roofline.token_flops(b, rows)
        assert roofline.decode_attention_lane(a, rows) == roofline.decode_attention_lane(b, rows)
    assert roofline.prompt_flops(a, 3, 40) == roofline.prompt_flops(b, 3, 40)
    assert roofline.qmm_call(a, "int8", 128, 512, 4) == roofline.qmm_call(b, "int8", 128, 512, 4)


def test_unknown_model_type_names_the_path(nano_root):
    home = nano_root / "portbench"
    config = dict(nano.NANO, name="nano-x", model_type="nosuch")
    (home / "configs" / "nano-x.json").write_text(json.dumps(config))
    (home / "limits" / "nanox-tiny.json").write_text(json.dumps({"logit_gap": 1e-3}))
    spec = json.loads((nano_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "nano-x", "source": "test", "reduced": [], "why": "test",
                            "file": "portbench/configs/nano-x.json"})
    spec["workloads"].append({"name": "nanox-tiny", "config": "nano-x", "traffic": "tiny",
                              "chips": 1, "why": "test"})
    (nano_root / "BENCHMARK.json").write_text(json.dumps(spec))
    want = str(nano_root.resolve() / "portbench" / "families" / "nosuch")
    with pytest.raises(FileNotFoundError, match=re.escape(want)):
        Bench(nano_root).cell("nanox-tiny")
