"""By parsing every import statement: nothing in ``benchmark/`` imports a
module whose top-level name, compared whole, is ``jax``, ``jaxlib``,
``flax`` or ``vqatpu`` (the port's name begins with the JAX package's),
and nothing under ``benchmark/reference/`` imports the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vqatpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_sources_are_found():
    assert BENCH / "run.py" in SOURCES
    assert any(p.parent.name == "reference" for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "vqatpu_torch" not in top_level_imports(path)


def test_the_rule_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import vqatpu_torch.train\nfrom jax import numpy\n"
                     "import flax.linen\nfrom . import sibling\n")
    assert top_level_imports(probe) == {"vqatpu_torch", "jax", "flax"}
    assert not {"vqatpu_torch"} & FORBIDDEN
