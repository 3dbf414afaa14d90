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


def test_reference_is_plain():
    names = top_level_imports(HOME / "reference.py")
    assert names <= {"__future__", "math", "typing", "torch"}, names
    assert "zig_gpt2_tpu_torch" not in names


def test_names_compared_whole():
    assert forbidden_modules(["zig_gpt2_tpu_torch", "zig_gpt2_tpu_torch.models"]) == []
    assert forbidden_modules(["zig_gpt2_tpu.models.gpt2", "numpy"]) == ["zig_gpt2_tpu"]
    assert forbidden_modules(["jaxlib.xla_client", "jaxtyping"]) == ["jaxlib"]
    assert forbidden_modules(["flax"]) == ["flax"]
