"""Loader for the reference's JLD2 test fixtures.

Counterpart of ``blocksparse_tpu/interop/jld2.py``, a copy of it: numpy and
``h5py`` only, ``h5py`` imported inside the functions (a machine without it
imports this module all the same).  ``tests/test_torch_jld2.py`` holds the
two loaders equal on a file written in this layout.

JLD2 is an HDF5 dialect, so ``h5py`` can read it without Julia.  The one
fixture shipped with the reference is
``test/assets/symmetricblockexamples.jld2`` -- a Julia
``Dict{String,Tuple}`` serialized as a ``blockdict`` dataset whose values
are 5-tuples ``(diagonalblocks, selfindices, offdiagonalblocks,
testindices, trialindices)`` (loaded at the reference's
test/test_symmetricblockmatrix.jl:9-16).  Keys are ``"sphere"`` and
``"cuboid"`` -- BEM near-field decompositions with ComplexF64 blocks and
sorted-but-scattered index lists.

Julia -> numpy conventions handled here:

- matrices are stored column-major, so h5py yields the transposed shape:
  a Julia ``m x k`` block reads as ``(k, m)`` and must be transposed back;
- ``ComplexF64`` is a compound ``(re, im)`` dtype -> ``complex128``;
- index vectors are 1-based ``Int64`` -> 0-based ``int64``.

JLD2 wraps every non-scalar in HDF5 object references (including the
Dict's key/value vector), hence the dereference helpers below.  Custom
Julia type metadata lives in reference-typed HDF5 *attributes* that h5py
cannot parse -- never read ``.attrs`` here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_symmetric_examples"]


def _deref(f, x):
    """Follow HDF5 object references down to concrete numpy data."""
    import h5py

    if isinstance(x, h5py.h5r.Reference):
        return _deref(f, f[x][()])
    if isinstance(x, np.ndarray) and x.dtype == object:
        return [_deref(f, e) for e in x]
    return x


def _to_complex(a: np.ndarray) -> np.ndarray:
    """Compound (re, im) -> complex128; plain floats pass through."""
    if a.dtype.names and set(a.dtype.names) >= {"re", "im"}:
        return (a["re"] + 1j * a["im"]).astype(np.complex128)
    return a


def _block(f, ref) -> np.ndarray:
    # Julia column-major: h5py reads (cols, rows); transpose restores m x k.
    return np.ascontiguousarray(_to_complex(_deref(f, ref)).T)


def _indices(f, ref) -> np.ndarray:
    idx = np.asarray(_deref(f, ref), dtype=np.int64)
    if idx.min() < 1:
        raise ValueError("expected 1-based Julia indices")
    return idx - 1


def load_symmetric_examples(path):
    """Load ``symmetricblockexamples.jld2``.

    Returns ``{name: (diagonals, diagonalindices, offdiagonals,
    rowindices, colindices)}`` with 0-based indices and complex128
    row-major blocks, ready for :class:`SymmetricBlockMatrix` (the tuple
    order matches the reference ctor call,
    test_symmetricblockmatrix.jl:20-28; pass ``device=`` to the
    constructor as for any other blocks).
    """
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        kvvec = f[f["blockdict"][()]["kvvec"]][()]
        for kvref in kvvec:
            kv = f[kvref][()]
            name = kv["first"]
            if isinstance(name, bytes):
                name = name.decode()
            diagb, selfi, offb, testi, triali = (
                kv["second"][str(i)] for i in range(1, 6)
            )
            out[name] = (
                [_block(f, r) for r in _deref(f, diagb)],
                [_indices(f, r) for r in _deref(f, selfi)],
                [_block(f, r) for r in _deref(f, offb)],
                [_indices(f, r) for r in _deref(f, testi)],
                [_indices(f, r) for r in _deref(f, triali)],
            )
    return out
