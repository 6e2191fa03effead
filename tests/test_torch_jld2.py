"""The port's JLD2 loader (``interop/jld2.py``) against the JAX package's.

The reference's fixture is not in the repository, so the tests write a
small file in the layout the loader reads (a JLD2 file is HDF5): a scalar
compound ``blockdict`` whose ``kvvec`` field references a vector of object
references, one per key/value pair; each pair a compound of ``first`` (the
name) and ``second``, whose fields ``"1"``-``"5"`` reference vectors of
references to the blocks and index lists; complex blocks as compound
``(re, im)`` stored column-major (h5py reads a Julia m x k block as
(k, m)); 1-based Int64 index vectors.  The port's loader is held equal to
the JAX one array by array, and a complex128 ``SymmetricBlockMatrix`` built
from it to the JAX operator and to scipy at 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blocksparse_tpu as bst
import blocksparse_tpu_torch as bt
from blocksparse_tpu.interop.jld2 import (
    load_symmetric_examples as jax_load)
from blocksparse_tpu_torch.interop.jld2 import load_symmetric_examples
from blocksparse_tpu_torch.utils.testmatrices import random_symmetric

h5py = pytest.importorskip("h5py")
torch.set_num_threads(2)

TOL = 1e-13
EXAMPLES = {"sphere": (31, 150, 8, 10), "cuboid": (32, 110, 5, 6)}


def write_jld2(path, examples, base=1):
    """Write ``{name: (diagonals, diagonalindices, offdiagonals, rowindices,
    colindices)}`` in the reference fixture's JLD2 layout, the indices
    ``base``-based."""
    ref = h5py.ref_dtype
    cplx = np.dtype([("re", "<f8"), ("im", "<f8")])
    counter = iter(range(1 << 30))

    with h5py.File(path, "w") as f:
        def dataset(data):
            return f.create_dataset(f"_{next(counter)}", data=data).ref

        def refs(items):
            return dataset(np.array(items, dtype=ref))

        def block(b):
            c = np.empty(b.T.shape, cplx)  # column-major: h5py reads (k, m)
            c["re"], c["im"] = b.real.T, b.imag.T
            return dataset(c)

        def index(i):
            return dataset(np.asarray(i, np.int64) + base)

        second = np.dtype([(str(k), ref) for k in range(1, 6)])
        pair = np.dtype([("first", h5py.string_dtype()), ("second", second)])
        kvs = []
        for name, (d, di, o, ri, ci) in examples.items():
            value = np.array((refs([block(b) for b in d]),
                              refs([index(i) for i in di]),
                              refs([block(b) for b in o]),
                              refs([index(i) for i in ri]),
                              refs([index(i) for i in ci])), dtype=second)
            kvs.append(dataset(np.array((name, value), dtype=pair)))
        f.create_dataset("blockdict", data=np.array(
            (refs(kvs),), dtype=[("kvvec", ref)]))


def examples():
    """Two complex128 symmetric operands with sorted, scattered groups."""
    return {name: random_symmetric(seed, n=n, ngroups=g, noffdiag=o,
                                   dtype=np.complex128)[:5]
            for name, (seed, n, g, o) in EXAMPLES.items()}


@pytest.fixture(scope="module")
def fixture_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("jld2") / "symmetricblockexamples.jld2"
    write_jld2(path, examples())
    return path


def test_loader_equals_the_jax_loader(fixture_file):
    """Every array of the port's load equals the JAX load's and the data
    written, dtype and bytes."""
    mine, ref, want = (load_symmetric_examples(fixture_file),
                       jax_load(fixture_file), examples())
    assert sorted(mine) == sorted(ref) == sorted(EXAMPLES)
    for name in EXAMPLES:
        assert len(mine[name]) == len(ref[name]) == 5
        for got, theirs, data in zip(mine[name], ref[name], want[name]):
            assert len(got) == len(theirs) == len(data)
            for a, b, c in zip(got, theirs, data):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
                assert np.array_equal(a, c)
                assert a.flags.c_contiguous
        assert mine[name][0][0].dtype == np.complex128
        assert mine[name][1][0].dtype == np.int64


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_symmetric_operator_from_the_file(fixture_file, name):
    """``S @ x``, ``S.H @ x`` and ``to_scipy`` of the port's operator on
    the loaded blocks against the JAX operator and scipy at 1e-13."""
    args = load_symmetric_examples(fixture_file)[name]
    n = EXAMPLES[name][1]
    S = bt.SymmetricBlockMatrix(*args, (n, n), device="cpu")
    Sj = bst.SymmetricBlockMatrix(*jax_load(fixture_file)[name], (n, n))
    assert S.dtype == torch.complex128
    ref = bst.to_scipy(Sj)
    mine = bt.to_scipy(S)
    assert abs(mine - ref).max() < TOL * max(1.0, abs(ref).max())
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    scale = max(1.0, float(np.abs(ref @ x).max()))
    for got, theirs, oracle in (
            (S @ torch.from_numpy(x), Sj @ jnp.asarray(x), ref @ x),
            (S.H @ torch.from_numpy(x), Sj.H @ jnp.asarray(x),
             ref.conj().T @ x)):
        got = got.numpy()
        assert np.abs(got - np.asarray(theirs)).max() < TOL * scale
        assert np.abs(got - oracle).max() < TOL * scale


def test_zero_based_indices_raise(tmp_path):
    """A file with 0-based indices raises ``ValueError`` in both loaders."""
    path = tmp_path / "zero_based.jld2"
    write_jld2(path, examples(), base=0)
    for load in (load_symmetric_examples, jax_load):
        with pytest.raises(ValueError, match="1-based Julia indices"):
            load(path)


def test_module_imports_no_h5py_at_top_level():
    """h5py is imported inside the loader: the card's machine has none."""
    import ast
    import inspect

    from blocksparse_tpu_torch.interop import jld2

    tree = ast.parse(inspect.getsource(jld2))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name for n in top for a in n.names}
    assert "h5py" not in names and not any("jax" in m or "blocksparse_tpu"
                                           == m for m in names)
