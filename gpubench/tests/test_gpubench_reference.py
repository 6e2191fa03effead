import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.configs import bem_sphere as g
from gpubench.reference.bem import round_tf32

CFGS = ["bem_laplace_f32", "bem_helmholtz_c64"]
SEED = 2**31 + 99


def dense(cfg, st, points) -> np.ndarray:
    """The operator assembled densely in float64 / complex128 from the
    points, the near pairs and the double-layer rule alone: off the
    diagonal ``w exp(ikr) (1 - ikr) / (8 pi r)``, ``w = 4 pi / n``; on it
    ``1/2`` less the kernel integrated over a disk of area ``w`` (by the
    trapezoid rule here)."""
    p = points.numpy()
    k = g.wavenumber(cfg)
    complex_ = cfg["dtype"].startswith("complex")
    w = 4 * np.pi / st.n
    A = np.zeros((st.n, st.n), np.complex128 if complex_ else np.float64)
    rng = [np.arange(s, s + m) for s, m in zip(st.starts, st.sizes)]
    pairs = [(i, i) for i in range(len(rng))] + [tuple(q) for q in st.pairs]
    for i, j in pairs:
        for a, b in ((i, j), (j, i)):
            r = np.linalg.norm(p[rng[a]][:, None] - p[rng[b]][None], axis=-1)
            with np.errstate(divide="ignore", invalid="ignore"):
                G = w * np.exp(1j * k * r) * (1 - 1j * k * r) / (8 * np.pi * r)
            A[np.ix_(rng[a], rng[b])] = G if complex_ else G.real
    a = np.sqrt(w / np.pi)
    r = np.linspace(0, a, 200001)
    f = np.exp(1j * k * r) * (1j * k * r - 1)
    c = 0.5 - 0.25 * (f.sum() - 0.5 * (f[0] + f[-1])) * (r[1] - r[0])
    np.fill_diagonal(A, c if complex_ else c.real)
    return A


@pytest.fixture(scope="module", params=CFGS)
def case(request):
    cfg = {**harness.config(request.param), "n": 2048}
    st = g.structure(cfg)
    vals = g.values(st, cfg, SEED, "cpu")
    ref = g.reference_of(cfg, st, vals.points)
    return cfg, st, vals, ref, dense(cfg, st, vals.points)


def test_reference_matches_a_dense_float64_assembly(case):
    cfg, st, vals, ref, A = case
    X = torch.randn(st.n, 3, dtype=torch.float64)
    if cfg["dtype"].startswith("complex"):
        X = X.to(torch.complex128)
    got = ref.apply(X).numpy()
    want = A @ X.numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    c = A[0, 0]
    assert ref.self_term == pytest.approx(c, rel=1e-12)
    assert g.self_term(st.n, g.wavenumber(cfg)) == pytest.approx(
        c if cfg["dtype"].startswith("complex") else c.real, rel=1e-12)


def test_program_operator_matches_the_assembly(case):
    cfg, st, vals, ref, A = case
    system = g.setup(cfg, SEED, "cpu", lambda m: None)
    x = torch.randn(st.n, dtype=system.dtype)
    got = (system.op @ x).numpy()
    want = A @ x.numpy().astype(A.dtype)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_block_jacobi_inverses(case):
    cfg, st, vals, ref, A = case
    inv = ref.jacobi_inverses()
    for lf in (0, len(st.sizes) - 1):
        s, m = st.starts[lf], st.sizes[lf]
        D = A[s:s + m, s:s + m]
        assert np.allclose(D @ inv[lf, :m, :m].numpy(), np.eye(m), atol=1e-12)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_reference_solves_reach_the_tolerance(case, solver):
    cfg, st, vals, ref, A = case
    if solver == "cg" and cfg["dtype"].startswith("complex"):
        pytest.skip("CG needs a Hermitian operator; the complex one is symmetric")
    B = torch.randn(st.n, 2, dtype=torch.float64).to(ref._compute_dtype("float64"))
    X = ref.solve(solver, B, tol=1e-10, maxiter=200)
    assert float(ref.relative_residuals(B, X).max()) < 1e-9


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    y = round_tf32(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]
    z = round_tf32(torch.complex(x, -x))
    assert torch.equal(z.real, y) and torch.equal(z.imag, -y)
