"""The port stands alone: no module of ``visual_odom_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and ``chip_smoke.py``
refuses to run without a card or without the port beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "visual_odom_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "visual_odom_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_with_jax_blocked():
    """Every module of the port imports while ``import jax`` would fail."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'visual_odom_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import visual_odom_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    r = _python(code, ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 15


def _smoke_fails(cwd):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_chip_smoke_refuses_without_card(tmp_path, where):
    """Without a CUDA device (and, alone in a directory, without the port)
    chip_smoke.py exits non-zero and prints no result line."""
    if where == "checkout":
        _smoke_fails(ROOT)
    else:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        _smoke_fails(tmp_path)
