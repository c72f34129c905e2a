"""Nothing under bench/ imports JAX or the JAX package (``repro``), and the
plain references import nothing of the program (``repro_torch``): each
imported module's top-level name, the part before the first dot,
compared whole (``repro_torch`` begins with ``repro``)."""

import ast
from pathlib import Path

import pytest

import tiny  # noqa: F401
from bench import harness

FILES = sorted(harness.BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.BENCH)))
def test_no_jax(path):
    if path.parent.name == "tests":
        return   # the tests may import both sides; the harness may not
    found = set(top_level_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = set(top_level_imports(path)) & {"repro_torch", "repro", "jax"}
    assert not found, f"{path} imports {found}"


def test_the_check_compares_whole_names():
    assert harness.forbidden_loaded({"repro_torch.models": None,
                                     "reprox": None}) == []
    assert harness.forbidden_loaded({"repro.kernels": None,
                                     "jax.numpy": None}) == \
        ["jax.numpy", "repro.kernels"]


def test_the_scan_sees_each_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy\nfrom repro.models import x\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n"
                 "import repro_torch\n")
    assert set(top_level_imports(f)) == {"jax", "repro", "importlib",
                                         "flax", "repro_torch"}
