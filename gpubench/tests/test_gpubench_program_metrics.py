"""The readers of the program's own spans and counters: each against a
registry and a launch count filled by hand, None on a solve record and on
an empty registry, and their entries in BENCHMARK.json."""

import types

import pytest
import torch

from gpubench import harness

from blocksparse_tpu_torch.utils import build, profiling

SPANS = {"construct_s.setup": ("bsp.construct",),
         "layout_s.setup": ("bsp.layout",),
         "coloring_s.setup": ("bsp.coloring",),
         "stage_s.setup": ("bsp.host_values", "bsp.stage"),
         "patch_plan_s.setup": ("bsp.plan.patch",)}
NEW = {*SPANS, "padding.rhs"}
ACCEPTED_CELLS = {"helmholtz_c64.rhs64", "laplace_f32.rhs64"}


def products():
    return {"loop": "products", "units": 4, "launches": {}}


def solve():
    return {"loop": "solve", "units": 4, "launches": {}}


@pytest.fixture
def clean(monkeypatch):
    """An empty registry and launch count, with a clock that steps by the
    values handed to it (nanoseconds)."""
    profiling.reset()
    build.reset_launch_counts()
    steps = []
    monkeypatch.setattr(profiling, "_clock", lambda: steps.pop(0))
    yield steps
    profiling.reset()
    build.reset_launch_counts()


def record(steps, name, start_s, end_s):
    steps += [int(start_s * 1e9), int(end_s * 1e9)]
    with profiling.annotate(name):
        pass


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_sums_its_spans(clean, metric):
    names = SPANS[metric]
    record(clean, "bsp.unrelated", 0.0, 7.0)
    want = 0.0
    for i, name in enumerate(names):
        record(clean, name, 1.0, 2.5 + i)
        record(clean, name, 10.0, 10.25)
        want += 1.5 + i + 0.25
    assert harness.reader(metric)(products()) == pytest.approx(want)


def fill_launches(monkeypatch):
    """Three launches through the funnel, on a stub library whose entry
    points return 0: two over a table (its entries counted), one over
    none."""
    lib = types.SimpleNamespace(bst_a=lambda *a: 0, bst_b=lambda *a: 0)
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda", 0)
    build.launch("bst_a", dev, 1, entries=(300, 100))
    build.launch("bst_a", dev, 1, entries=(300, 100))
    build.launch("bst_b", dev, 2)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_is_none_on_a_solve_record_and_an_empty_registry(
        clean, monkeypatch, metric):
    read = harness.reader(metric)
    assert read(products()) is None
    for names in SPANS.values():
        for name in names:
            record(clean, name, 0.0, 1.0)
    fill_launches(monkeypatch)
    assert read(solve()) is None
    assert read(products()) is not None


def test_padding_reads_the_funnel(clean, monkeypatch):
    fill_launches(monkeypatch)
    assert harness.reader("padding.rhs")(products()) == pytest.approx(3.0)


def test_new_entries_have_readers_and_list_accepted_cells():
    bench = harness.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(entries) == NEW
    for name, m in entries.items():
        assert (harness.HERE / "metrics" / f"{name}.py").exists()
        assert m["workloads"] and set(m["workloads"]) <= ACCEPTED_CELLS
        assert m["moves"] == ("rhs_per_s" if name.endswith(".rhs")
                              else "setup_s")
    assert entries["patch_plan_s.setup"]["workloads"] == ["laplace_f32.rhs64"]


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_is_none_on_a_program_without_registry_or_counts(
        clean, monkeypatch, metric):
    """A commit of the program before the registry and the counts (the
    parent side of a comparison) reads None and raises nothing."""
    for names in SPANS.values():
        for name in names:
            record(clean, name, 0.0, 1.0)
    fill_launches(monkeypatch)
    monkeypatch.delattr(profiling, "summary")
    monkeypatch.delattr(build, "launch_counts")
    assert harness.reader(metric)(products()) is None
