"""The port stands alone: no module of mpgcn_tpu_torch/, and none of its
scripts (chip_smoke.py, kernel_hashes.py, n500_int8_step.py,
lstm_fwd_probe.py), imports
JAX or the JAX package. Imports are read with ``ast`` -- a string match
would confuse ``mpgcn_tpu_torch`` with ``mpgcn_tpu``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mpgcn_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _sources():
    files = sorted((ROOT / "mpgcn_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_hashes.py",
                    ROOT / "n500_int8_step.py", ROOT / "lstm_fwd_probe.py",
                    ROOT / "precision_times.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(ast.parse(path.read_text()))
           if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_tells_the_packages_apart():
    tree = ast.parse("import mpgcn_tpu_torch.nn\n"
                     "from mpgcn_tpu_torch import config\n"
                     "import jax.numpy as jnp\n"
                     "from mpgcn_tpu.data import loader\n"
                     "import importlib; importlib.import_module('jaxlib')\n")
    assert [m for m in _imports(tree) if _forbidden(m)] == [
        "jax.numpy", "mpgcn_tpu.data", "jaxlib"]
