import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.configs import bem_sphere as g

CFGS = ["bem_laplace_f32", "bem_helmholtz_c64"]


def small(name, n=2048):
    return {**harness.config(name), "n": n}


@pytest.mark.parametrize("name", CFGS)
def test_structure_is_a_leaf_sorted_near_field(name):
    cfg = small(name)
    st = g.structure(cfg)
    assert st.sizes.max() <= cfg["leaf_size"] and st.sizes.min() >= 1
    assert st.starts[0] == 0 and np.all(np.diff(st.starts) == st.sizes[:-1])
    assert st.starts[-1] + st.sizes[-1] == cfg["n"]
    assert np.all(st.pairs[:, 0] < st.pairs[:, 1])
    assert len({tuple(p) for p in st.pairs}) == st.pairs.shape[0]
    # every point once, on the unit sphere
    assert np.allclose(np.linalg.norm(st.points, axis=1), 1.0)
    assert np.unique(st.points, axis=0).shape[0] == cfg["n"]


def test_structure_does_not_depend_on_the_seed_and_values_do():
    cfg = small("bem_helmholtz_c64")
    a, b = g.structure(cfg), g.structure(cfg)
    assert np.array_equal(a.pairs, b.pairs) and np.array_equal(a.sizes, b.sizes)
    v1 = g.values(a, cfg, 2**31 + 7, "cpu")
    v2 = g.values(a, cfg, 2**31 + 7, "cpu")
    v3 = g.values(a, cfg, 2**31 + 8, "cpu")
    assert torch.equal(v1.off, v2.off) and torch.equal(v1.diag, v2.diag)
    assert torch.equal(v1.points, v2.points)
    assert not torch.equal(v1.off, v3.off)
    assert v1.off.shape == v3.off.shape and v1.off.dtype == torch.complex64


def test_jitter_stays_within_its_share_of_the_spacing():
    cfg = small("bem_laplace_f32")
    st = g.structure(cfg)
    p = g.jittered_points(st, cfg, 5, "cpu")
    h = np.sqrt(4 * np.pi / cfg["n"])
    move = (p - torch.from_numpy(st.points)).norm(dim=1)
    assert float(move.max()) <= cfg["jitter"] * h + 1e-15
    assert float(move.max()) > 0
    assert torch.allclose(p.norm(dim=1), torch.ones(cfg["n"], dtype=p.dtype))


def test_near_pairs_follow_admissibility():
    cfg = small("bem_laplace_f32")
    st = g.structure(cfg)
    leaves = [st.points[s:s + m] for s, m in zip(st.starts, st.sizes)]
    lo = np.stack([lf.min(0) for lf in leaves])
    hi = np.stack([lf.max(0) for lf in leaves])
    diam = np.linalg.norm(hi - lo, axis=1)
    near = set(map(tuple, st.pairs))
    for i in range(len(leaves)):
        for j in range(i + 1, len(leaves)):
            gap = np.maximum(0, np.maximum(lo[j] - hi[i], lo[i] - hi[j]))
            want = np.linalg.norm(gap) < cfg["eta"] * max(diam[i], diam[j])
            assert ((i, j) in near) == want


def test_wavenumber_from_points_per_wavelength():
    cfg = harness.config("bem_helmholtz_c64")
    h = np.sqrt(4 * np.pi / cfg["n"])
    assert g.wavenumber(cfg) == pytest.approx(2 * np.pi / (10 * h))
    assert g.wavenumber(harness.config("bem_laplace_f32")) == 0.0
