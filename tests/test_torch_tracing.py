"""The port's spans and launch counts on the CPU (``utils/profiling.py``,
``utils/build.launch``).

Spans nest and sum into calls, total and self seconds; the constructors
and the lazy plans record their set-up spans always; a product records
``bsp.apply.<route>`` of the route it took only while a profiler records,
and reads no clock otherwise; ``trace`` puts the registry's spans on the
profiler's clock in one file; the launch funnel counts launches and the
tile and stored entries of the tables and plans it is given.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import dispatch, patch_engine
from blocksparse_tpu_torch.ops.dispatch import (bucket_tables, layouts_of,
                                                set_population_policy)
from blocksparse_tpu_torch.utils import build, profiling
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

N = 384


@pytest.fixture
def registry():
    profiling.reset()
    build.reset_launch_counts()
    yield
    profiling.reset()
    build.reset_launch_counts()


@pytest.fixture
def policy(monkeypatch):
    """A population-policy table of the test's own."""
    monkeypatch.setattr(dispatch, "_POPULATION_POLICY", {})


def symmetric(seed=3, contiguous=True):
    d, di, o, ri, ci, shape = random_symmetric(
        seed, n=N, ngroups=12, noffdiag=20, dtype=np.float32,
        contiguous=contiguous)
    return bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")


def general(seed=4):
    blocks, rows, cols, shape = random_block_sparse(
        seed, shape=(N, N), nblocks=24, max_block=40, dtype=np.float32,
        contiguous=True)
    return bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu")


def vbcrs(seed=5):
    blocks, rs, cs, shape = random_vbcrs(seed, shape=(N, N), nrowgroups=10,
                                         ncolgroups=10, dtype=np.float32)
    return bt.VariableBlockCompressedRowStorage(blocks, rs, cs, shape,
                                                device="cpu")


def by_name(records):
    out = {}
    for s in records:
        out.setdefault(s.name, []).append(s)
    return out


# -- the span facility ---------------------------------------------------------

def test_spans_nest_with_parents_and_self_time(registry, monkeypatch):
    ticks = iter([0, 10, 12, 15, 40, 100, 150, 1000])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks) * 10**6)
    with profiling.annotate("outer", blocks=3) as outer:
        with profiling.annotate("inner"):
            with profiling.annotate("leaf"):
                pass
        with profiling.annotate("inner") as second:
            second.set(r=8)
    spans = by_name(profiling.spans())
    (o,), (leaf,) = spans["outer"], spans["leaf"]
    inner = spans["inner"]
    assert o.parent is None and o.attrs == {"blocks": 3}
    assert [s.parent for s in inner] == [o.id, o.id]
    assert leaf.parent == inner[0].id
    assert inner[1].attrs == {"r": 8}
    summary = profiling.summary()
    assert summary["leaf"] == {"calls": 1, "total_s": pytest.approx(3e-3),
                               "self_s": pytest.approx(3e-3)}
    assert summary["inner"]["calls"] == 2
    assert summary["inner"]["total_s"] == pytest.approx((40 - 10 + 150 - 100)
                                                        * 1e-3)
    assert summary["inner"]["self_s"] == pytest.approx(80e-3 - 3e-3)
    assert summary["outer"]["total_s"] == pytest.approx(1.0)
    assert summary["outer"]["self_s"] == pytest.approx(1.0 - 80e-3)
    profiling.reset()
    assert profiling.spans() == [] and profiling.summary() == {}


def test_spans_are_operator_ranges_of_the_profiler(registry):
    """A span is an operator-scope range, not a user annotation: the
    profiler ties what is launched inside it (here an aten op; on a card a
    kernel launched through ctypes) to the span."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("bsp.outer"):
            with profiling.annotate("bsp.launch.probe"):
                torch.ones(4) + 1
    events = {e.name: e for e in prof.events() if e.name.startswith("bsp.")}
    assert not events["bsp.launch.probe"].is_user_annotation
    assert "aten::add" in {c.name for c in
                           events["bsp.launch.probe"].cpu_children}
    assert events["bsp.launch.probe"].cpu_parent.name == "bsp.outer"


def test_span_closes_on_an_exception(registry):
    with pytest.raises(RuntimeError):
        with profiling.annotate("outer"):
            with profiling.annotate("failing"):
                raise RuntimeError("boom")
    with profiling.annotate("after"):
        pass
    spans = by_name(profiling.spans())
    assert spans["failing"][0].parent == spans["outer"][0].id
    assert spans["after"][0].parent is None


def test_registry_stays_bounded(registry, monkeypatch):
    monkeypatch.setattr(profiling, "_records",
                        profiling.collections.deque(maxlen=32))
    for _ in range(12):  # 4 spans each
        general()
    kept = profiling.spans()
    assert len(kept) == 32
    assert len(by_name(kept)["bsp.construct"]) == 8  # the newest
    assert profiling.summary()["bsp.construct"]["calls"] == 12
    assert profiling.summary()["bsp.layout"]["calls"] == 12
    assert profiling._records.maxlen == 32
    assert profiling.MAX_SPANS >= 1024


# -- set-up spans ----------------------------------------------------------------

def test_symmetric_construction_spans(registry):
    S = symmetric()
    spans = by_name(profiling.spans())
    (c,) = spans["bsp.construct"]
    assert c.attrs == {"format": "symmetric",
                       "blocks": S.ndiagonals + S.noffdiagonals}
    for name, count in (("bsp.layout", 2), ("bsp.stage", 2),
                        ("bsp.coloring", 4), ("bsp.host_values", 1)):
        assert len(spans[name]) == count, name
        assert {s.parent for s in spans[name]} == {c.id}
    assert [s.attrs["colors"] for s in spans["bsp.coloring"]] == [
        len(S.diagonalcolors()), len(S.offdiagonalcolors()),
        len(S.transposeoffdiagonalcolors()), len(S.fusedcolors())]
    assert sorted(s.attrs["buckets"] for s in spans["bsp.layout"]) == sorted(
        len(lay.buckets) for lay in (S._dlayout, S._olayout))
    children = sum(s.end_ns - s.start_ns for s in profiling.spans()
                   if s.parent == c.id)
    assert children <= c.end_ns - c.start_ns


@pytest.mark.parametrize("make,fmt,layouts,colorings", [
    (general, "general", 1, 0),
    (vbcrs, "vbcrs", 1, 0),
])
def test_general_and_vbcrs_construction_spans(registry, make, fmt, layouts,
                                              colorings):
    op = make()
    spans = by_name(profiling.spans())
    (c,) = spans["bsp.construct"]
    assert c.attrs["format"] == fmt and c.attrs["blocks"] == op.nblocks
    assert len(spans["bsp.layout"]) == layouts
    assert len(spans["bsp.stage"]) == layouts
    assert len(spans.get("bsp.coloring", [])) == colorings
    assert all(s.parent == c.id for s in profiling.spans() if s is not c)


def test_colored_general_construction_colors_both_directions(registry):
    blocks, rows, cols, shape = random_block_sparse(
        6, shape=(N, N), nblocks=24, max_block=40, dtype=np.float32)
    bt.BlockSparseMatrix(blocks, rows, cols, shape, device="cpu",
                         schedule="colored")
    spans = by_name(profiling.spans())
    assert len(spans["bsp.coloring"]) == 2
    assert {s.parent for s in spans["bsp.coloring"]} == {
        spans["bsp.construct"][0].id}


def test_patch_plan_span_at_first_matrix_product(registry):
    S = symmetric()
    X = torch.randn(N, 8)
    profiling.reset()
    S @ X
    S @ X
    (plan,) = by_name(profiling.spans())["bsp.plan.patch"]
    assert plan.parent is None and plan.attrs["transpose"] == 0


def test_stream_plan_spans(registry):
    A = general()
    x = torch.randn(N)
    profiling.reset()
    A @ x
    names = {s.name for s in profiling.spans()}
    assert {"bsp.plan.panel", "bsp.plan.strip"} <= names


# -- hot-path spans ----------------------------------------------------------------

ROUTE_CASES = [("bucket", 8), ("patch", 8), ("bucket", 1), ("patch", 1),
               ("panel", 1), ("slab", 1)]


@pytest.mark.parametrize("route,r", ROUTE_CASES)
def test_product_records_the_pinned_route_under_a_profiler(registry, policy,
                                                           route, r):
    A = general()
    for lay in layouts_of(A):
        set_population_policy(lay, "spmv" if r == 1 else "spmm", route)
    x = torch.randn(N) if r == 1 else torch.randn(N, r)
    y = A @ x  # plans built outside the profile
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.reset()
        y2 = A @ x
    applies = [s for s in profiling.spans() if s.name.startswith("bsp.apply.")]
    assert [(s.name, s.attrs) for s in applies] == [
        (f"bsp.apply.{route}", {"r": r})]
    assert {e.key for e in prof.key_averages()} >= {f"bsp.apply.{route}"}
    torch.testing.assert_close(y2, y)
    torch.testing.assert_close(y, A.todense() @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route,r", ROUTE_CASES)
def test_no_hot_span_and_no_clock_read_without_a_profiler(registry, policy,
                                                          monkeypatch, route,
                                                          r):
    A = general()
    for lay in layouts_of(A):
        set_population_policy(lay, "spmv" if r == 1 else "spmm", route)
    x = torch.randn(N) if r == 1 else torch.randn(N, r)
    A @ x  # set-up spans of the lazy plans, outside the check

    def no_clock():
        raise AssertionError("a hot-path span read the clock")

    monkeypatch.setattr(profiling, "_clock", no_clock)
    profiling.reset()
    assert not profiling.recording()
    A @ x
    assert profiling.spans() == []


def test_symmetric_product_under_a_profiler_takes_the_patch_route(registry):
    S = symmetric()
    X = torch.randn(N, 8)
    S @ X
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        S @ X
    assert [s.name for s in profiling.spans()] == ["bsp.apply.patch"]


def test_complex_product_takes_the_bucket_route(registry):
    d, di, o, ri, ci, shape = random_symmetric(7, n=N, ngroups=12,
                                               noffdiag=20,
                                               dtype=np.complex64)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    X = torch.randn(N, 4, dtype=torch.complex64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        S @ X
    assert [s.name for s in profiling.spans()
            if s.name.startswith("bsp.apply.")] == ["bsp.apply.bucket"]


# -- one clock with the profiler's trace -------------------------------------------

def test_trace_file_holds_registry_and_profiler_spans_on_one_clock(registry,
                                                                   tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        S = symmetric()
        S @ torch.randn(N, 8)
    (name,) = os.listdir(logdir)
    with open(logdir / name) as f:
        doc = json.load(f)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"
              and e["name"].startswith("bsp.")]
    registry_ev = {e["name"]: e for e in events
                   if e.get("cat") == "bsp_span"}
    profiler_ev = {e["name"]: e for e in events
                   if e.get("cat") != "bsp_span"}
    names = {"bsp.construct", "bsp.layout", "bsp.coloring", "bsp.stage",
             "bsp.plan.patch", "bsp.apply.patch"}
    assert names <= set(registry_ev) and names <= set(profiler_ev)
    for n in names:
        assert abs(registry_ev[n]["ts"] - profiler_ev[n]["ts"]) < 1000, n
        reg_end = registry_ev[n]["ts"] + registry_ev[n]["dur"]
        prof_end = profiler_ev[n]["ts"] + profiler_ev[n]["dur"]
        assert abs(reg_end - prof_end) < 1000, n
    # the absolute clock: the trace's base plus ts is the Unix epoch
    base_us = doc["baseTimeNanoseconds"] / 1e3
    construct = [s for s in profiling.spans() if s.name == "bsp.construct"][0]
    assert abs(base_us + registry_ev["bsp.construct"]["ts"]
               - construct.start_ns / 1e3) < 1


# -- the launch funnel's counts ------------------------------------------------------

@pytest.fixture
def stub_library(monkeypatch):
    """``build.load_library`` stubbed to a library whose entry points
    return 0 (no error), and a current CUDA device and stream stubbed, so
    the funnel runs on the CPU; returns the calls each entry saw."""
    calls = {}

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.setdefault(name, []).append(args)
                return 0
            return entry

    monkeypatch.setattr(build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


def test_funnel_counts_launches_and_entries_per_entry(registry,
                                                      stub_library):
    dev = torch.device("cuda", 0)
    build.launch("bst_fused_spmm_mma_c64", dev, 1, 2, entries=(1000, 310))
    build.launch("bst_fused_spmm_mma_c64", dev, 1, 2, entries=(1000, 310))
    build.launch("bst_patch_sym_f32", dev, 3, entries=(500, 200))
    build.launch("bst_patch_xt_f32", dev, 4)
    assert build.launch_counts() == {
        "bst_fused_spmm_mma_c64": {"launches": 2, "tile_entries": 2000,
                                   "stored_entries": 620},
        "bst_patch_sym_f32": {"launches": 1, "tile_entries": 500,
                              "stored_entries": 200},
        "bst_patch_xt_f32": {"launches": 1, "tile_entries": 0,
                             "stored_entries": 0}}
    # the current stream rides last on every call
    assert stub_library["bst_patch_xt_f32"] == [(4, 7)]
    build.reset_launch_counts()
    assert build.launch_counts() == {}


def test_funnel_records_launch_spans_only_under_a_profiler(registry,
                                                          stub_library):
    dev = torch.device("cuda", 0)
    build.launch("bst_a", dev, entries=(8, 4))
    assert profiling.spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("bsp.apply.bucket"):
            build.launch("bst_a", dev, entries=(8, 4))
            build.launch("bst_b", dev)
    spans = by_name(profiling.spans())
    (a,), (b,) = spans["bsp.launch.bst_a"], spans["bsp.launch.bst_b"]
    assert a.attrs == {"tile_entries": 8, "stored_entries": 4}
    assert b.attrs == {}
    assert a.parent == b.parent == spans["bsp.apply.bucket"][0].id
    assert {"bsp.launch.bst_a", "bsp.launch.bst_b"} <= {
        e.key for e in prof.key_averages()}
    assert build.launch_counts()["bst_a"]["launches"] == 2


def test_funnel_counts_nothing_on_an_error(registry, monkeypatch):
    lib = types.SimpleNamespace(bst_bad=lambda *a: 1,
                                bst_error_string=lambda e: b"stub error")
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    with pytest.raises(RuntimeError, match="stub error"):
        build.launch("bst_bad", torch.device("cuda", 0), entries=(2, 1))
    assert build.launch_counts() == {}


def test_no_entry_launches_counter_left():
    from blocksparse_tpu_torch.ops.kernels import fused_spmm, mask_select
    assert not hasattr(fused_spmm, "ENTRY_LAUNCHES")
    assert "ENTRY_LAUNCHES" not in vars(mask_select)


# -- the precomputed entry counts ------------------------------------------------------

@pytest.mark.parametrize("make", [symmetric, general, vbcrs,
                                  lambda: symmetric(8, contiguous=False)])
def test_bucket_tables_count_the_layouts_entries(make):
    op = make()
    pairs = ([(op._dbuckets, op._dlayout), (op._obuckets, op._olayout)]
             if hasattr(op, "_dlayout") else [(op._buckets, op._layout)])
    for staged, layout in pairs:
        tables = [t for t in bucket_tables(staged, layout).values()
                  if t is not None]
        assert sum(t.entries[0] for t in tables) == layout.padded_nnz
        assert sum(t.entries[1] for t in tables) == layout.nnz
        assert sum(layout.stored_by_bucket) == layout.nnz


@pytest.mark.parametrize("make", [symmetric, general])
def test_patch_plan_counts(make):
    op = make()
    entry = op._patch_entry(False)
    plan, arrays = entry
    want = sum(b.nb * b.MP * b.KP for b in plan.buckets)
    got = patch_engine.plan_entries(plan)
    assert sum(t for t, _ in got) == want
    assert sum(s for _, s in got) == plan.logical_nnz
    assert [a.entries for a in arrays] == got
    stored = sum(lay.nnz for lay in layouts_of(op))
    assert plan.logical_nnz == stored


# -- the table launches' autograd node ------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
def test_table_launch_takes_an_autograd_node_only_where_a_gradient_flows(
        registry, grad):
    d, di, o, ri, ci, shape = random_symmetric(9, n=N, ngroups=12,
                                               noffdiag=20,
                                               dtype=np.complex64)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device="cpu")
    X = torch.randn(N, 4, dtype=torch.complex64, requires_grad=grad)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        Y = S @ X
    names = {e.key for e in prof.key_averages()}
    assert ("TableApply" in names) == grad
    assert Y.requires_grad == grad
    want = torch.from_numpy(bt.to_scipy(S).toarray()) @ X.detach()
    torch.testing.assert_close(Y.detach(), want, rtol=1e-4, atol=1e-4)
    if grad:
        G = torch.randn_like(Y)
        (Y * G.conj()).real.sum().backward()
        # y = S x gives x's cotangent S^H g (torch's convention)
        dense = torch.from_numpy(bt.to_scipy(S).toarray())
        torch.testing.assert_close(X.grad, dense.conj().T @ G, rtol=1e-4,
                                   atol=1e-4)
