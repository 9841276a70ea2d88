"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys

import pytest

from vobench import run, spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "visual_odom_tpu_torch"


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_sources_import_no_jax(path):
    assert not set(_imported(path)) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_imported(path))


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    tops = _python(
        "import json, sys\n"
        "import vobench.reference.step, vobench.check, vobench.bank\n"
        "import vobench.lkwork, vobench.synthetic\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert PROGRAM not in tops
    assert not set(tops) & set(run.FORBIDDEN)


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, then the modules it loaded."""
    tops = _python(
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from vobench.tests import test_vobench_run as t\n"
        "from vobench import bank, run\n"
        "b = bank.render(20, t.H, t.W, course_frames=60, workers=1)\n"
        "res = t.run('live', b)\n"
        "assert res['correct'], res\n"
        "print(json.dumps(run.loaded_forbidden()))")
    assert tops == []
