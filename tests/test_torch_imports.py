"""The PyTorch port stands alone: importing it loads no JAX, Flax, orbax,
scikit-learn or resuneta_tpu, and no file of it (or chip_smoke.py) imports
them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test files of the port import both)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "resuneta_tpu",
             "sklearn")
PORT_FILES = sorted((ROOT / "resuneta_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "resuneta_torch." + str(p.relative_to(ROOT / "resuneta_torch"))
        .removesuffix(".py").replace(os.sep, ".").removesuffix(".__init__")
        for p in (ROOT / "resuneta_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            "import resuneta_torch\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
