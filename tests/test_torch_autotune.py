"""The port's autotune (``utils/autotune.py``) and population policy on the CPU.

The measuring needs the card; the deciding does not.  So these tests give
the times (:func:`decide`, :func:`decide_optimize`, or a stand-in for the
timer) and check the choice, the report, the policy and the routing that
follows, on each of the three formats:

- every route open to an operator (``open_routes``: bucket, panel, slab,
  patch) gives the JAX product within the f32 tolerance (float64 operators
  have the bucket route alone, at 1e-13), and is the route that ran
  (the route entry points counted);
- a set policy routes the products of every operator of that population,
  and a route not open to a product falls through to the rules;
- the errors of ``autotune_backend`` / ``autotune_optimize``;
- an operator that was never tuned never computes its layout's digest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.core.patch import build_patch_plan
from blocksparse_tpu_torch.formats import block_sparse, stream, symmetric, vbcrs
from blocksparse_tpu_torch.ops import dispatch, patch_engine
from blocksparse_tpu_torch.utils import autotune
from blocksparse_tpu_torch.utils.autotune import (autotune_backend,
                                                  autotune_optimize, decide,
                                                  decide_optimize,
                                                  open_routes)
from blocksparse_tpu_torch.utils.testmatrices import (random_block_sparse,
                                                      random_symmetric,
                                                      random_vbcrs)

torch.set_num_threads(2)

TOL32, TOL64 = 1e-5, 1e-13
FORMATS = ["BlockSparseMatrix", "SymmetricBlockMatrix",
           "VariableBlockCompressedRowStorage"]


def args_of(fmt, dtype=np.float32):
    if fmt == "BlockSparseMatrix":
        return random_block_sparse(5, shape=(512, 512), nblocks=24,
                                   max_block=64, dtype=dtype, contiguous=True)
    if fmt == "SymmetricBlockMatrix":
        return random_symmetric(6, n=512, ngroups=10, noffdiag=14,
                                dtype=dtype, contiguous=True)
    return random_vbcrs(7, shape=(512, 512), nrowgroups=10, ncolgroups=10,
                        dtype=dtype)


def port(fmt, dtype=np.float32, **kw):
    return getattr(bt, fmt)(*args_of(fmt, dtype), device="cpu", **kw)


@pytest.fixture(autouse=True)
def empty_policy():
    dispatch._POPULATION_POLICY.clear()
    yield
    dispatch._POPULATION_POLICY.clear()


def routed(apply):
    """(result, the routes whose entry points ran)."""
    ran = []
    spies = [(stream, "panel_run", "panel"), (stream, "slab_apply", "slab"),
             (patch_engine, "patch_apply", "patch"),
             (block_sparse, "apply_operand", "bucket"),
             (vbcrs, "apply_operand", "bucket"),
             (symmetric, "apply_symmetric", "bucket")]
    origs = []
    for mod, name, route in spies:
        fn = getattr(mod, name)
        origs.append((mod, name, fn))

        def spy(*a, _fn=fn, _route=route, **k):
            ran.append(_route)
            return _fn(*a, **k)
        setattr(mod, name, spy)
    try:
        return apply(), ran
    finally:
        for mod, name, fn in origs:
            setattr(mod, name, fn)


def relerr(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def operand(n, r, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if r == 1 else (n, r)).astype(dtype)


@pytest.mark.parametrize("fmt", FORMATS)
def test_open_routes(fmt):
    """Every route is open to an f32 operator of contiguous blocks at
    r = 1, bucket and patch at r > 1; ``patch="never"`` closes patch; a
    float64 or complex operator, or one of scattered lists, has the bucket
    route alone."""
    assert open_routes(port(fmt), 1) == ["bucket", "panel", "slab", "patch"]
    assert open_routes(port(fmt), 4) == ["bucket", "patch"]
    assert open_routes(port(fmt, patch="never"), 1) == ["bucket", "panel",
                                                        "slab"]
    assert open_routes(port(fmt, np.float64), 1) == ["bucket"]
    assert open_routes(port(fmt, np.complex64), 4) == ["bucket"]
    if fmt == "BlockSparseMatrix":
        scattered = bt.BlockSparseMatrix(*random_block_sparse(
            5, shape=(512, 512), nblocks=24, max_block=64,
            dtype=np.float32), device="cpu")
        assert open_routes(scattered, 1) == ["bucket"]


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("fmt", FORMATS)
def test_every_open_route_matches_jax(fmt, r):
    """Each open route, pinned on a copy, runs (its entry point counted)
    and gives the JAX operator's product, A and A^T, within the f32
    tolerance; the float64 operator's one route within 1e-13."""
    A = port(fmt)
    Aj = getattr(bst, fmt)(*args_of(fmt))
    n = A.shape[1]
    x = operand(n, r)
    for route in open_routes(A, r):
        B = autotune._pinned_copy(A, route)
        for op, jop in ((B, Aj), (B.T, Aj.T)):
            y, ran = routed(lambda: op @ torch.from_numpy(x))
            assert ran == [route], (route, ran)
            assert relerr(y, jop @ jnp.asarray(x)) < TOL32
        assert B._stream is A._stream  # plans shared, not rebuilt
    A64 = port(fmt, np.float64)
    A64j = getattr(bst, fmt)(*args_of(fmt, np.float64))
    x64 = operand(n, r, dtype=np.float64)
    (route,) = open_routes(A64, r)
    y, ran = routed(lambda: autotune._pinned_copy(A64, route)
                    @ torch.from_numpy(x64))
    assert ran == ["bucket"]
    assert relerr(y, A64j @ jnp.asarray(x64)) < TOL64


@pytest.mark.parametrize("fmt", FORMATS)
def test_policy_routes_the_population(fmt):
    """A winner recorded by ``decide`` routes the products of every
    operator whose layouts have the same content (a second operator built
    from the same blocks included), not those of another population; the
    report is kept on the operator."""
    A, twin = port(fmt), port(fmt)
    other = getattr(bt, fmt)(*args_of(fmt), device="cpu",
                             granularity=(8, 128))
    x = torch.from_numpy(operand(A.shape[1], 1))
    _, before = routed(lambda: other @ x)
    report = decide(A, "spmv", {"bucket": 9.0, "panel": 5.0, "slab": 2.0,
                                "patch": 7.0})
    assert report == {"kind": "spmv", "winner": "slab", "applied": True,
                      "times_us": {"bucket": 9.0, "panel": 5.0, "slab": 2.0,
                                   "patch": 7.0}}
    assert A._autotune_reports["spmv"] is report
    for op in (A, twin, A.T):
        assert routed(lambda: op @ x)[1] == ["slab"]
    assert routed(lambda: other @ x)[1] == before
    assert routed(lambda: A @ x[:, None].repeat(1, 3))[1] != ["slab"]
    decide(A, "spmm", {"bucket": 1.0, "patch": 2.0})
    X = torch.from_numpy(operand(A.shape[1], 4))
    assert routed(lambda: twin @ X)[1] == ["bucket"]
    unapplied = decide(port(fmt), "spmv", {"bucket": 1.0, "panel": 2.0},
                       set_policy=False)
    assert not unapplied["applied"]
    assert routed(lambda: twin @ x)[1] == ["slab"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_route_not_open_falls_through(fmt):
    """The policy's route where the product cannot take it -- "panel" for
    an r > 1 product, "patch" on a ``patch="never"`` operator of the same
    population, "slab" for a float64 operand -- leaves the rules to decide:
    the untuned operator's route, and its product."""
    A = port(fmt)
    never = port(fmt, patch="never")
    x = torch.from_numpy(operand(A.shape[1], 1))
    X = torch.from_numpy(operand(A.shape[1], 4))
    cases = [(A, X), (never, x), (A, x.double())]
    untuned = [routed(lambda: op @ v) for op, v in cases]
    for lay in autotune._layouts_of(A):
        dispatch.set_population_policy(lay, "spmm", "panel")
        dispatch.set_population_policy(lay, "spmv", "patch")
    tuned = [routed(lambda: op @ v) for op, v in cases[:2]]
    for lay in autotune._layouts_of(A):
        dispatch.set_population_policy(lay, "spmv", "slab")
    tuned.append(routed(lambda: A @ x.double()))
    for (y0, ran0), (y1, ran1) in zip(untuned, tuned):
        assert ran1 == ran0
        assert torch.equal(y0, y1)


def test_policy_checks_its_arguments():
    A = port("BlockSparseMatrix")
    with pytest.raises(ValueError, match="kind"):
        dispatch.set_population_policy(A.layout, "spmx", "bucket")
    with pytest.raises(ValueError, match="route"):
        dispatch.set_population_policy(A.layout, "spmv", "pallas")
    assert dispatch.population_policy(A.layout, "spmv") is None


@pytest.mark.parametrize("name", ["autotune_backend", "autotune_optimize"])
def test_errors(name):
    """Non-square: ``ValueError``; off the card: ``RuntimeError`` saying the
    module measures the card's routes."""
    fn = getattr(autotune, name)
    rect = bt.BlockSparseMatrix(*random_block_sparse(
        83, shape=(96, 128), nblocks=4, max_block=16, dtype=np.float32,
        contiguous=True), device="cpu")
    with pytest.raises(ValueError, match="requires a square operator, got "
                                         r"\(96, 128\)"):
        fn(rect)
    with pytest.raises(RuntimeError, match="measures the card's routes"):
        fn(port("BlockSparseMatrix"))
    assert not dispatch._POPULATION_POLICY


@pytest.mark.parametrize("fmt", FORMATS)
def test_untuned_operator_never_computes_its_digest(fmt):
    """With the policy table empty no product hashes the operator's
    values: r = 1 and r > 1, A and A^T, through every rule's route."""
    A = port(fmt)
    for r in (1, 4):
        x = torch.from_numpy(operand(A.shape[1], r))
        A @ x, A.T @ x
    A.H @ x
    assert all("digest" not in vars(lay) for lay in autotune._layouts_of(A))
    decide(port(fmt), "spmv", {"bucket": 1.0, "panel": 2.0})
    A @ torch.from_numpy(operand(A.shape[1], 1))
    assert all("digest" in vars(lay) for lay in autotune._layouts_of(A))


@pytest.fixture
def fake_card(monkeypatch):
    """The measuring on the CPU: the device check passes and the timer
    reads the pinned route's (or the plan bias's) time from a table."""
    table = {}
    seen = []

    def time_us(B, x, repeats):
        B @ x
        seen.append(B)
        return table[B._pinned if B._pinned != "patch" or B._optimize is None
                     else B._optimize]

    monkeypatch.setattr(autotune, "_check", lambda A, name: None)
    monkeypatch.setattr(autotune, "_time_us", time_us)
    return table, seen


@pytest.mark.parametrize("fmt", FORMATS)
def test_autotune_backend_flow(fmt, fake_card):
    """The whole of ``autotune_backend`` with given times: every open route
    timed on a copy sharing A's plans, the winner recorded and routing
    the next product; one open route: an unapplied report, kept nowhere."""
    table, seen = fake_card
    table.update(bucket=40.0, panel=30.0, slab=35.0, patch=20.0)
    A = port(fmt)
    report = autotune_backend(A, r=1)
    assert report["times_us"] == table and report["winner"] == "patch"
    assert report["applied"] and A._autotune_reports["spmv"] is report
    assert [B._pinned for B in seen] == ["bucket", "panel", "slab", "patch"]
    assert all(B._stream is A._stream for B in seen)
    x = torch.from_numpy(operand(A.shape[1], 1))
    assert routed(lambda: A @ x)[1] == ["patch"]
    report = autotune_backend(A, r=64, set_policy=False)
    assert set(report["times_us"]) == {"bucket", "patch"}
    assert not report["applied"]
    one = port(fmt, np.float64)
    report = autotune_backend(one)
    assert report["winner"] == "bucket" and not report["applied"]
    assert "note" in report and not hasattr(one, "_autotune_reports")


@pytest.mark.parametrize("fmt", FORMATS)
def test_autotune_optimize_flow(fmt, fake_card):
    """``autotune_optimize`` times the patch route under each bias on a copy
    with a plan of its own, sets the winner and drops A's plan; the next
    plan is the winner's, and A's own plan never held the other's."""
    table, seen = fake_card
    table.update(latency=12.0, throughput=10.0)
    A = port(fmt)
    before = A._patch_entry(False)
    report = autotune_optimize(A)
    plans = report.pop("plans")
    assert report == {"kind": "optimize", "latency_us": 12.0,
                      "throughput_us": 10.0, "winner": "throughput",
                      "applied": True}
    assert plans["latency"] != plans["throughput"]
    assert [B._optimize for B in seen] == ["latency", "throughput"]
    assert A._optimize == "throughput"
    lays = autotune._layouts_of(A)
    want = (build_patch_plan(lays[0], extra_layout=lays[1],
                             optimize="throughput")
            if len(lays) == 2 else build_patch_plan(lays[0],
                                                    optimize="throughput"))
    plan = A._patch_entry(False)[0]
    assert plan is not before[0]
    assert plan.buckets[0].G == want.buckets[0].G
    assert np.array_equal(plan.buckets[0].vals, want.buckets[0].vals)
    X = torch.from_numpy(operand(A.shape[1], 4))
    Aj = getattr(bst, fmt)(*args_of(fmt))
    assert relerr(autotune._pinned_copy(A, "patch") @ X,
                  Aj @ jnp.asarray(X.numpy())) < TOL32
    report = decide_optimize(port(fmt), {"latency": 1.0, "throughput": 2.0},
                             apply=False)
    assert report["winner"] == "latency" and not report["applied"]
    none = autotune_optimize(port(fmt, np.float64))
    assert none["latency_us"] is None and not none["applied"]


def test_autotune_optimize_one_plan(fake_card):
    """Where both biases give one plan (here 48 blocks of 128 x 128 on 8 x
    8 tiles) the plan is timed once and ``optimize`` stays as it was."""
    table, seen = fake_card
    table.update(latency=12.0, throughput=10.0)
    rng = np.random.default_rng(7)
    pos = rng.choice(64, size=48, replace=False)
    A = bt.BlockSparseMatrix(
        [rng.standard_normal((128, 128)).astype(np.float32) for _ in pos],
        [np.arange(p // 8 * 128, p // 8 * 128 + 128) for p in pos],
        [np.arange(p % 8 * 128, p % 8 * 128 + 128) for p in pos],
        (1024, 1024), device="cpu")
    report = autotune_optimize(A)
    assert not report["applied"] and A._optimize is None
    assert report["plans"]["latency"] == report["plans"]["throughput"]
    assert report["latency_us"] == 12.0 and report["throughput_us"] is None
    assert [B._optimize for B in seen] == ["latency"]
    assert "note" in report and not hasattr(A, "_autotune_reports")
