"""No module the benchmark runs is JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the program
under test."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from conftest import HERE, PB, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "patchperpix_tpu"}
PROGRAM = "patchperpix_tpu_torch"


def _imports(path):
    """Top-level names of every module a file imports (absolute or, for
    a relative import, its package's)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("portbench" if node.level else
                    node.module.split(".")[0])
    return out


def _files(folder):
    for dirpath, _, names in os.walk(folder):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


@pytest.mark.parametrize("path", sorted(_files(PB)),
                         ids=lambda p: os.path.relpath(p, PB))
def test_no_jax_in_any_file(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted(_files(os.path.join(PB, "reference"))),
    ids=lambda p: os.path.relpath(p, PB))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _imports(path)


def test_top_level_names_compared_whole():
    # the program's name begins with the JAX package's
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert PROGRAM.startswith("patchperpix_tpu")


RUN = r"""
import sys, time, json, tempfile
sys.path[:0] = [{root!r}, {here!r}]
import torch, conftest
from portbench import harness, run as runner
root = tempfile.mkdtemp()
bench = harness.read_json({root!r} + "/BENCHMARK.json")
conftest._shrink(bench, root)
for cell in {cells!r}:
    args = runner.parse(["--workload", cell, "--seed", "3", "--seconds",
                         "0.5", "--trace", "1"])
    runner.run(args, root=root, bench_path={root!r} + "/BENCHMARK.json",
               device=torch.device("cpu"), t0=time.perf_counter())
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def test_modules_loaded_by_runs(tmp_path):
    """What a run of each cell loads, drivers, readers and the program
    included, in a fresh process."""
    import json

    from conftest import TRAIN

    code = RUN.format(root=ROOT, here=HERE, cells=[TRAIN])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in tops and not (tops & FORBIDDEN)
