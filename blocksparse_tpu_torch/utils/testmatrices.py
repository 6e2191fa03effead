"""Synthetic BEM-like test-matrix generators.

numpy copy of ``blocksparse_tpu/utils/testmatrices.py``, so the port's
scripts can build the same fixtures without importing jax; the same seed
gives the same arrays in both packages.

The reference's fixtures are block decompositions extracted from
boundary-element problems on a sphere and a cuboid (SURVEY.md §4): N ~= 1.2-1.35k, ~100
diagonal blocks (1-28 wide), ~100 off-diagonal blocks (up to ~141 wide),
ComplexF64, with index lists that are *sorted but non-contiguous* gather
lists.  These generators regenerate statistically equivalent fixtures
deterministically from a seed, for both the scattered-index formats (1-2)
and the contiguous-range VBCRS format (leaf-sorted, docs/src/vbcrs.md:27-78).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "random_partition",
    "scattered_groups",
    "random_block_sparse",
    "random_symmetric",
    "random_vbcrs",
]


def random_partition(rng: np.random.Generator, n: int, ngroups: int):
    """Partition range(n) into contiguous groups of random sizes >= 1."""
    cuts = np.sort(rng.choice(np.arange(1, n), size=ngroups - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    return [np.arange(bounds[i], bounds[i + 1]) for i in range(ngroups)]


def scattered_groups(rng: np.random.Generator, n: int, ngroups: int):
    """Partition range(n) into disjoint *scattered* (sorted, non-contiguous)
    index groups -- the reference fixtures' index statistics."""
    perm = rng.permutation(n)
    groups = random_partition(rng, n, ngroups)
    return [np.sort(perm[g]) for g in groups]


def _rand(rng, shape, dtype):
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        return (
            rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        ).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def random_block_sparse(
    seed: int,
    shape=(1300, 1300),
    nblocks: int = 100,
    max_block: int = 80,
    dtype=np.complex128,
    contiguous: bool = False,
    sorted_indices: bool = True,
):
    """Blocks at random (possibly overlapping) row/col index lists.

    Returns (blocks, rowindices, colindices, shape).
    """
    rng = np.random.default_rng(seed)
    m, n = shape
    blocks, rows, cols = [], [], []
    for _ in range(nblocks):
        bm = int(rng.integers(1, max_block + 1))
        bk = int(rng.integers(1, max_block + 1))
        if contiguous:
            r0 = int(rng.integers(0, m - bm + 1))
            c0 = int(rng.integers(0, n - bk + 1))
            ri = np.arange(r0, r0 + bm)
            ci = np.arange(c0, c0 + bk)
        else:
            ri = rng.choice(m, size=bm, replace=False)
            ci = rng.choice(n, size=bk, replace=False)
            if sorted_indices:
                ri, ci = np.sort(ri), np.sort(ci)
        blocks.append(_rand(rng, (bm, bk), dtype))
        rows.append(ri)
        cols.append(ci)
    return blocks, rows, cols, shape


def random_symmetric(
    seed: int,
    n: int = 1300,
    ngroups: int = 40,
    noffdiag: int = 90,
    dtype=np.complex128,
    contiguous: bool = False,
):
    """BEM-like symmetric structure: one diagonal block per index group plus
    off-diagonal blocks between distinct groups (each unordered pair at most
    once, so S = D + O + O^T has no accidental overlaps on mirrored entries).

    Returns (diagonals, diagonalindices, offdiagonals, rowindices,
    colindices, shape).
    """
    rng = np.random.default_rng(seed)
    groups = (
        random_partition(rng, n, ngroups)
        if contiguous
        else scattered_groups(rng, n, ngroups)
    )
    diagonals = [_rand(rng, (len(g), len(g)), dtype) for g in groups]
    diagonalindices = list(groups)

    pairs = set()
    offdiagonals, rowindices, colindices = [], [], []
    tries = 0
    while len(offdiagonals) < noffdiag and tries < 50 * noffdiag:
        tries += 1
        a, b = rng.integers(0, ngroups, size=2)
        if a == b or (min(a, b), max(a, b)) in pairs:
            continue
        pairs.add((min(int(a), int(b)), max(int(a), int(b))))
        ga, gb = groups[int(a)], groups[int(b)]
        offdiagonals.append(_rand(rng, (len(ga), len(gb)), dtype))
        rowindices.append(ga)
        colindices.append(gb)
    return diagonals, diagonalindices, offdiagonals, rowindices, colindices, (n, n)


def random_vbcrs(
    seed: int,
    shape=(1200, 1200),
    nrowgroups: int = 30,
    ncolgroups: int = 30,
    fill: float = 0.15,
    dtype=np.float64,
):
    """VBCRS structure: contiguous row/col partitions, random nonempty tiles.

    Returns (blocks, row_starts, col_starts, shape).
    """
    rng = np.random.default_rng(seed)
    m, n = shape
    rgroups = random_partition(rng, m, nrowgroups)
    cgroups = random_partition(rng, n, ncolgroups)
    blocks, rstarts, cstarts = [], [], []
    for rg in rgroups:
        any_in_row = False
        for cg in cgroups:
            if rng.random() < fill:
                blocks.append(_rand(rng, (len(rg), len(cg)), dtype))
                rstarts.append(int(rg[0]))
                cstarts.append(int(cg[0]))
                any_in_row = True
        if not any_in_row:  # keep every block row populated
            cg = cgroups[int(rng.integers(0, ncolgroups))]
            blocks.append(_rand(rng, (len(rg), len(cg)), dtype))
            rstarts.append(int(rg[0]))
            cstarts.append(int(cg[0]))
    return blocks, rstarts, cstarts, shape
