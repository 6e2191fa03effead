"""The port's timing and profiling utilities on the CPU.

``utils/timing.chained_time_per_iter`` (the JAX signature and ``reduce``
modes: a positive, finite seconds-per-iteration, ordered min <= median <=
max under "stats", growing chain lengths until the window resolves) and
``utils/profiling.trace`` / ``annotate`` (a Chrome trace written into the
directory, nested ranges named in it).  CPU timings say nothing about a
card; these tests check the estimator's contract, not a speed.
"""

import json
import os

import numpy as np
import pytest
import torch

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.utils.profiling import annotate, trace
from blocksparse_tpu_torch.utils.testmatrices import random_block_sparse
from blocksparse_tpu_torch.utils.timing import chained_time_per_iter

torch.set_num_threads(2)


def operator():
    args = random_block_sparse(17, shape=(256, 256), nblocks=12,
                               dtype=np.float64, contiguous=True)
    return bt.BlockSparseMatrix(*args, device="cpu")


def step_of(A):
    def step(x):
        y = A @ x
        return y / y.norm()
    return step


@pytest.mark.parametrize("reduce", ["median", "min"])
def test_chained_time_is_positive_and_finite(reduce):
    A = operator()
    x0 = torch.ones(256, dtype=torch.float64)
    sec = chained_time_per_iter(step_of(A), x0, iters_lo=2, iters_hi=6,
                                repeats=3, reduce=reduce)
    assert isinstance(sec, float) and np.isfinite(sec) and sec > 0


def test_chained_time_stats_and_structures():
    A = operator()
    calls = []

    def step(state):
        calls.append(1)
        return {"x": step_of(A)(state["x"]), "k": state["k"]}

    stats = chained_time_per_iter(
        step, {"x": torch.ones(256, dtype=torch.float64), "k": (1, 2)},
        iters_lo=1, iters_hi=3, repeats=4, reduce="stats")
    assert set(stats) == {"min", "median", "max", "n"}
    assert 0 < stats["min"] <= stats["median"] <= stats["max"]
    assert 1 <= stats["n"] <= 4
    # a window this short on a fast step grows the chain lengths
    assert len(calls) > 4 * (1 + 3) + 2 * (1 + 3)


def test_chained_time_rejects_bad_arguments():
    with pytest.raises(ValueError, match="reduce"):
        chained_time_per_iter(lambda x: x, torch.ones(1), reduce="mean")
    with pytest.raises(ValueError, match="iters_lo"):
        chained_time_per_iter(lambda x: x, torch.ones(1), iters_lo=5,
                              iters_hi=5)


def test_trace_writes_a_chrome_trace_with_nested_ranges(tmp_path):
    A = operator()
    x = torch.ones(256, dtype=torch.float64)
    logdir = tmp_path / "trace"
    with trace(str(logdir)) as prof:
        with annotate("outer-product"):
            with annotate("inner-product"):
                A @ x
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("ph") == "X"}
    outer, inner = spans["outer-product"], spans["inner-product"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    names = {e.key for e in prof.key_averages()}
    assert {"outer-product", "inner-product"} <= names
