"""The comparison fails what it must fail, at a size a test run holds:
the control (the reference at TF32, the nearest precision below the
configurations' float32 at "highest") and the program with its timed path
broken underneath; and it passes the program as it is.  The solve cell,
held out of BENCHMARK.json, is added to a copy of it here, so the solve
path and its limits stay checked."""

import json

import pytest
import torch

import blocksparse_tpu_torch as bt
from gpubench import calibrate, harness
from gpubench.tests.conftest import SMALL

HELD_OUT = {"name": "helmholtz_c64.bicgstab", "config": "bem_helmholtz_c64",
            "traffic": "bicgstab", "chips": 1, "why": "the solve path"}
PRODUCTS = [w["name"] for w in harness.benchmark()["workloads"]]
SOLVES = [HELD_OUT["name"]]
CELLS = PRODUCTS + SOLVES


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    bench = harness.benchmark()
    bench["workloads"].append(HELD_OUT)
    path = tmp_path_factory.mktemp("bench")
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


def run(cell, root, seed=2**31 + 11):
    return harness.run_cell(cell, seed, 0.3, False, device="cpu", overrides=SMALL,
                            root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell, root):
    out = run(cell, root)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("seed", [2**31 + 21, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, seed, root):
    nums = calibrate.control(cell, seed, SMALL, torch.device("cpu"), root)
    ok, checks = harness.check.judge(nums, harness.limits(cell))
    assert not ok, checks
    for name, value in nums.items():
        assert value > 3 * harness.limits(cell)[name]["limit"], (name, value)


def _solver_fault(real, fault):
    def solver(A, b, **kw):
        if fault == "unchanged":  # returns its initial state
            x = torch.zeros_like(b)
            return x, bt.SolveInfo(torch.zeros((), dtype=torch.int32),
                                   torch.linalg.vector_norm(b), torch.tensor(True))
        x, info = real(A, b, **kw)
        x = x.clone()
        x[0] = -x[0]  # one entry of the answer altered where it is produced
        return x, info
    return solver


@pytest.mark.parametrize("fault", ["unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", SOLVES)
def test_broken_solve_is_caught(cell, fault, monkeypatch, root):
    name = harness.mix(harness.workload(harness.benchmark(root), cell)["traffic"])["solver"]
    monkeypatch.setattr(bt, name, _solver_fault(getattr(bt, name), fault))
    out = run(cell, root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", PRODUCTS)
def test_broken_product_is_caught(cell, fault, monkeypatch, root):
    real = bt.SymmetricBlockMatrix.__matmul__

    def matmul(self, X):
        if fault == "unchanged":  # the operand handed back
            return X.clone()
        if fault == "half_batch":  # half of the columns left out
            Y = torch.zeros_like(X)
            Y[:, : X.shape[1] // 2] = real(self, X[:, : X.shape[1] // 2])
            return Y
        Y = real(self, X).clone()
        Y[0, 0] = -Y[0, 0]  # one entry altered where it is produced
        return Y

    monkeypatch.setattr(bt.SymmetricBlockMatrix, "__matmul__", matmul)
    out = run(cell, root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_at_a_small_size(cell, card, root):
    out = harness.run_cell(cell, 2**31 + 31, 1.0, True, device=card,
                           overrides={"n": 8192}, root=root)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
