"""Shared fixtures of the benchmark's own tests: the card, and a small
copy of the benchmark's files that the CPU runs can hold."""

from __future__ import annotations

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TRAIN = "flylight_ppp_dec.train"


@pytest.fixture
def card():
    """The first CUDA device; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: on the card, python -m pytest "
                    "-m cuda portbench/tests")
    return torch.device("cuda", 0)


def _shrink(bench: dict, root: str):
    """The cells' configurations cut to sizes a CPU test holds: the
    published training model cut in width and depth to 4 / 8 feature maps
    at 44^3 crops."""
    from portbench.reference import model as ref_model

    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    for name in ("traffic", "drivers", "metrics"):
        os.symlink(os.path.join(PB, name), os.path.join(root, name))
    for w in bench["workloads"]:
        with open(os.path.join(PB, "configs", w["config"] + ".json")) as f:
            cfg = json.load(f)
        m = cfg["model"]
        m.update(num_fmaps=4, fmap_inc_factors=[2, 2],
                 fmap_dec_factors=[1.0, 1.0],
                 downsample_factors=[[2, 2, 2], [2, 2, 2]])
        m["autoencoder"].update(num_fmaps=[8, 16], num_code_samples=64)
        cfg["train_input_shape"] = [44, 44, 44]
        cfg["train_output_shape"] = ref_model.output_shape(
            ref_model.net_config(cfg), m["num_channels"], [44, 44, 44])
        cfg["data"]["reflect_to"] = [88, 88, 88]
        with open(os.path.join(root, "configs", w["config"] + ".json"),
                  "w") as f:
            json.dump(cfg, f)


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """(folder of the small benchmark files, path of BENCHMARK.json)."""
    root = str(tmp_path_factory.mktemp("portbench_small"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _shrink(bench, root)
    return root, os.path.join(ROOT, "BENCHMARK.json")


def run_small(small, cell, seed=7, seconds=1.0, trace=0):
    """One CPU run of a cell at the small sizes; the result line."""
    import time

    import torch

    from portbench import run as runner

    root, bench = small
    args = runner.parse(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)])
    return runner.run(args, root=root, bench_path=bench,
                      device=torch.device("cpu"), t0=time.perf_counter())


@pytest.fixture
def run_cell(small):
    """``run_cell(cell, seed=..., seconds=..., trace=...)``: one CPU run at
    the small sizes."""
    return lambda cell, **kw: run_small(small, cell, **kw)
