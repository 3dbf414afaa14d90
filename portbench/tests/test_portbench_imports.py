"""Nothing the benchmark runs is JAX or the JAX package, and the reference
takes nothing of the program: top-level module names compared whole."""

import ast
from pathlib import Path

import pytest

from portbench.run import forbidden_modules

HOME = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HOME.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "zig_gpt2_tpu"}


PLAIN = sorted([HOME / "reference.py", *HOME.glob("families/*/model.py")])
# What a plain file may take of the harness: its shared arithmetic and the
# seed's mapping (and, for the shared reference, the family it dispatches to).
SHARED = {"portbench.reference", "portbench.roofline", "portbench.traffic", "portbench.spec"}
GENERIC = sorted([*HOME.glob("*.py"), *HOME.glob("metrics/*.py")])
GPT2_KEYS = {"n_positions", "n_layer", "n_head", "n_embd", "layer_norm_epsilon"}


def imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.update([node.module] + [f"{node.module}.{a.name}" for a in node.names])
    return names


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: str(p.relative_to(HOME)))
def test_reference_is_plain(path):
    names = top_level_imports(path)
    assert names <= {"__future__", "copy", "math", "typing", "numpy", "torch",
                     "portbench"}, names
    ours = {m for m in imported_modules(path) if m.split(".")[0] == "portbench"}
    assert all(m in SHARED or m.rsplit(".", 1)[0] in SHARED for m in ours), ours


@pytest.mark.parametrize("path", GENERIC, ids=lambda p: str(p.relative_to(HOME)))
def test_generic_harness_knows_no_model(path):
    """The generic harness imports no model of the program and names no key
    of GPT-2's configuration: those are the families' alone."""
    assert not any(m.startswith("zig_gpt2_tpu_torch.models") for m in imported_modules(path))
    strings = {n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert not strings & GPT2_KEYS, strings & GPT2_KEYS


def test_names_compared_whole():
    assert forbidden_modules(["zig_gpt2_tpu_torch", "zig_gpt2_tpu_torch.models"]) == []
    assert forbidden_modules(["zig_gpt2_tpu.models.gpt2", "numpy"]) == ["zig_gpt2_tpu"]
    assert forbidden_modules(["jaxlib.xla_client", "jaxtyping"]) == ["jaxlib"]
    assert forbidden_modules(["flax"]) == ["flax"]
