"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference and the yardstick import nothing of the program: each import's
top-level name, compared whole (``repro_torch`` begins with ``repro``)."""
import ast
from pathlib import Path

import pytest

from perfbench import run

PACKAGE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(PACKAGE)))
def test_no_jax_anywhere(path):
    assert not set(_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("folder", ["reference", "counts"])
def test_reference_and_counts_import_nothing_of_the_program(folder):
    files = sorted((PACKAGE / folder).rglob("*.py"))
    assert files
    for path in files:
        assert "repro_torch" not in set(_tops(path)), path


def test_the_runs_own_check_compares_whole_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.serving",
                                  "torch", "reprox"]) == []
    assert run.forbidden_modules(["jax.numpy", "repro.config", "flax",
                                  "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]
