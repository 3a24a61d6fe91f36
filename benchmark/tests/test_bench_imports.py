"""Nothing under benchmark/ imports JAX, Flax, optax or the JAX package, and
the reference imports nothing of the program (top-level names compared whole)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "salve_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".", 1)[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [(line, name) for line, name in top_level_imports(path) if name in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [(line, name) for line, name in top_level_imports(path) if name == "salve_tpu_torch"]
    assert not bad, f"{path}: {bad}"


def test_the_rule_compares_whole_names():
    src = "import salve_tpu_torch.device\nfrom salve_tpu_torch import device\nimport jax.numpy\n"
    tmp = BENCH / "tests" / "_probe_imports.txt"
    tmp.write_text(src)
    try:
        names = [n for _, n in top_level_imports(tmp)]
    finally:
        tmp.unlink()
    assert names == ["salve_tpu_torch", "salve_tpu_torch", "jax"]
    assert [n for n in names if n in FORBIDDEN] == ["jax"]


def test_harness_finds_forbidden_modules_by_whole_name():
    from benchmark.harness import forbidden_modules

    assert forbidden_modules(["salve_tpu_torch", "salve_tpu_torch.ops", "numpy"]) == []
    assert forbidden_modules(["salve_tpu.ops.bev", "jaxlib", "flax.linen"]) == ["flax", "jaxlib", "salve_tpu"]
