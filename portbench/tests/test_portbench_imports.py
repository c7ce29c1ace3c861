"""Nothing under portbench/ imports JAX or the JAX package, by top-level
module name compared whole (the port's name begins with the JAX
package's), and the references import nothing of the program."""

from __future__ import annotations

import ast
import sys

import pytest

from conftest import BENCH
from harness import common

JAX = set(common.JAX_NAMES)


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_import(path):
    assert not set(imported_tops(path)) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert "gaussiangrasper_torch" not in tops
    assert tops <= {"__future__", "contextlib", "dataclasses", "math", "typing", "numpy", "torch",
                    "scipy"}


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussiangrasper_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert common.jax_modules() == [] or set(common.jax_modules()) <= JAX
    assert "gaussiangrasper_torch_fake" not in common.jax_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in common.jax_modules()
