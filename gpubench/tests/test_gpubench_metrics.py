"""Each per-layer reader against a recorded fake trace."""

from types import SimpleNamespace as NS

import pytest
import torch

from gpubench import harness, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, t0, t1, dev=CPU, device_s=0.0):
    return NS(name=name, device_type=dev, time_range=NS(start=t0, end=t1),
              device_time_total=device_s * 1e6, is_user_annotation=False)


class FakeProf:
    """Times in microseconds: a 1000 us window; kernels busy 100-300,
    250-400 and 700-800 us (400 us busy); two products of 0.15 / 0.1 ms."""

    def events(self):
        return [
            ev(trace.WINDOW, 0, 1000),
            ev("gpubench.solve", 10, 990),
            ev("gpubench.S", 50, 120, device_s=150e-6),
            ev("gpubench.M", 200, 260, device_s=100e-6),
            ev("cudaStreamSynchronize", 420, 690),
            ev("k_a", 100, 300, CUDA), ev("k_b", 250, 400, CUDA),
            ev("k_a", 700, 800, CUDA),
            ev("gpubench.S", 700, 800, CUDA),  # device-side annotation: not busy
            ev("k_out", 1200, 1300, CUDA),  # outside the window
        ]


def test_reduce_fake_trace():
    t = trace.reduce(FakeProf())
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(400e-6)
    spans = t["span_device_s"]
    assert spans["gpubench.S"] == pytest.approx(150e-6)
    assert spans["gpubench.M"] == pytest.approx(100e-6)
    assert t["span_calls"]["gpubench.S"] == 1
    ops = dict(t["breakdown"]["device_ops"])
    assert ops == pytest.approx({"k_a": 300e-6, "k_b": 150e-6})
    gaps = dict(t["breakdown"]["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-6)
    assert sum(gaps.values()) == pytest.approx(600e-6)


def solve_rec():
    return {"loop": "solve", "units": 4, "iterations": 64, "host_checks": 8,
            "launches": {"a": 100, "b": 28}, "calls": {"S": 72, "M": 68},
            "bounds": {"S": (1e-4, "bytes"), "M": (1e-5, "bytes")},
            "trace": {**trace.reduce(FakeProf()),
                      "span_device_s": {"gpubench.S": 72 * 2e-4,
                                        "gpubench.M": 68 * 4e-5}}}


def rhs_rec():
    return {"loop": "products", "units": 10, "columns": 64,
            "enqueue_s": [1e-4, 3e-4], "launches": {"a": 20},
            "calls": {"S": 10, "M": 0}, "bounds": {"S": (2e-3, "operations")},
            "trace": {"busy_s": 0.9, "window_s": 1.0,
                      "span_device_s": {"gpubench.S": 10 * 4e-3}}}


@pytest.mark.parametrize("name,rec,want", [
    ("iterations.solve", solve_rec, 16.0),
    ("host_reads.solve", solve_rec, 2.0),
    ("launches.solve", solve_rec, 2.0),
    ("products_roofline.solve", solve_rec,
     100 * (72 * 1e-4 + 68 * 1e-5) / (72 * 2e-4 + 68 * 4e-5)),
    ("device_idle.solve", solve_rec, 60.0),
    ("launches.rhs", rhs_rec, 2.0),
    ("enqueue_ms.rhs", rhs_rec, 0.2),
    ("products_roofline.rhs", rhs_rec, 50.0),
    ("device_idle.rhs", rhs_rec, 10.0),
])
def test_reader(name, rec, want):
    assert harness.reader(name)(rec()) == pytest.approx(want)


@pytest.mark.parametrize("name", [m["name"] for m in harness.benchmark()["per_layer"]])
def test_reader_finds_nothing_in_the_other_loop(name):
    """A reader returns None where its loop did not run, and never 0 for a
    roofline share without device time."""
    read = harness.reader(name)
    other = rhs_rec() if name.endswith(".solve") else solve_rec()
    assert read(other) is None
    empty = solve_rec() if name.endswith(".solve") else rhs_rec()
    empty["trace"] = {"busy_s": 0.0, "window_s": 1.0, "span_device_s": {}}
    if "roofline" in name or "idle" in name:
        assert read(empty) is None


def test_every_metric_has_a_reader_and_every_cell_reports_enough():
    bench = harness.benchmark()
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for w in bench["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, w["name"], True)


def test_reservoir_is_seeded_and_uniform():
    from collections import Counter

    from gpubench.loops import Reservoir

    def run(seed, n=50, k=5):
        r, kept = Reservoir(k, seed), [None] * k
        for i in range(n):
            j = r.slot()
            if j is not None:
                kept[j] = i
        return kept, r.kept

    assert run(7) == run(7) and run(7) != run(8)
    assert run(7, n=3)[1] == 3
    counts = Counter(i for s in range(2000) for i in run(s)[0])
    assert min(counts.values()) > 0.7 * 2000 * 5 / 50
    assert max(counts.values()) < 1.3 * 2000 * 5 / 50
