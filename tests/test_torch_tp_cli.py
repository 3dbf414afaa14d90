"""The mesh paths through the port's CLI against the JAX CLI with the same
flags: ``--demo --mesh 1x2 --temp 0 --max-tokens 8`` with
``--seq-parallel`` on one prompt, and over a file of four prompts with
``--prefix`` and with ``--draft-model ngram`` (prompt-lookup speculative
serving in the batcher). Float demo weights, greedy; the port on two CPU
ranks (``--device cpu``; the CLI started as a launcher's ranks, ``RANK``
and ``WORLD_SIZE`` set, started once for the module by
``torch_tp_worker.spawn_ranks``), the JAX CLI in the test process on the
first two of the conftest's virtual CPU devices (its ``make_mesh`` takes
every device, so the test hands it two). Rank 0 prints the JAX CLI's text
in each case.
"""

import contextlib
import io

import jax
import pytest

from tests.torch_tp_worker import spawn_ranks
from zig_gpt2_tpu import cli as jcli
from zig_gpt2_tpu.parallel import mesh as jmesh

PROMPTS = ["the quick brown", "hello world", "the lazy dog over", "quick brown fox"]
COMMON = ["--demo", "--mesh", "1x2", "--temp", "0", "--max-tokens", "8"]
CASES = {
    "seq-parallel": ["--seq-parallel", "the quick"],
    "prefix": ["--batch-file", "{prompts}", "--prefix", "the quick"],
    "draft-ngram": ["--batch-file", "{prompts}", "--draft-model", "ngram"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: the port's rank-0 text}, {case: the JAX CLI's text})."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    (tmp / "prompts.txt").write_text("\n".join(PROMPTS) + "\n")
    argv = {name: COMMON + [a.format(prompts=tmp / "prompts.txt") for a in flags]
            for name, flags in CASES.items()}
    join = spawn_ranks(1, 2, [{"name": name, "kind": "cli", "argv": args + ["--device", "cpu"]}
                              for name, args in argv.items()], tmp)
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        make_mesh = jmesh.make_mesh
        mp.setattr(jmesh, "make_mesh",
                   lambda dp, tp=None, devices=None: make_mesh(dp, tp, jax.devices()[:dp * tp]))
        for name, args in argv.items():
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                jcli.main(args)
            ref[name] = out.getvalue()
    ranks = join()
    return {name: ranks[0][name]["out"] for name in CASES}, ref


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_cli_prints_the_jax_cli_text(runs, name):
    got, want = runs
    assert got[name] == want[name]
    lines = want[name].splitlines()
    if name == "seq-parallel":
        assert lines[0].startswith("the quick") and len(lines[0]) > len("the quick") + 4
    else:
        assert len(lines) == len(PROMPTS) and all('"completion"' in line for line in lines)
