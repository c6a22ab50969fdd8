"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""

import ast
import os

import pytest

from harness.main import FORBIDDEN, HERE


def _modules(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules(HERE)),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & set(FORBIDDEN), path


@pytest.mark.parametrize("path", sorted(_modules(os.path.join(HERE,
                                                              "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    mods = set(_imports(path))
    assert "resuneta_torch" not in mods and "harness" not in mods, path


def test_the_scan_compares_whole_top_level_names():
    # the port's top-level name begins with the JAX package's
    assert "resuneta_torch".split(".")[0] not in FORBIDDEN
    assert "resuneta_tpu.models".split(".")[0] in FORBIDDEN
