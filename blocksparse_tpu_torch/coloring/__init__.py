"""Greedy graph coloring of blocks: conflict-free rounds.

Counterpart of ``blocksparse_tpu/coloring/__init__.py`` (its pure-Python
path; the JAX package's C++ coloring gives the same assignment and is not
carried).  Two blocks *conflict* iff their output index lists intersect; a
color is a group of pairwise non-conflicting blocks.

The assignments are the JAX package's, byte for byte
(``tests/test_torch_coloring.py``): DSATUR picks the uncolored vertex with
the highest (saturation, degree), ties to the lowest vertex id, and gives
it the smallest color no neighbour holds.  The implementation differs for
speed at production block counts: the conflict graph comes from a sparse
incidence product instead of per-index pair loops, and DSATUR keeps its
candidates in a heap (O((V + E) log V)) instead of rescanning every vertex
per step (O(V^2)).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..utils.profiling import annotate

__all__ = [
    "ColorInfo",
    "conflict_adjacency",
    "dsatur_color",
    "color_blocks",
    "validate_coloring",
]


@dataclass(frozen=True)
class ColorInfo:
    """Conflict specification over per-block output index lists: element
    ids are block ids, two blocks conflict iff their lists intersect."""

    indexlists: tuple[np.ndarray, ...]

    @property
    def nblocks(self) -> int:
        return len(self.indexlists)

    @property
    def max_index(self) -> int:
        return max((int(ix.max()) for ix in self.indexlists if ix.size), default=-1)


def _neighbours(indexlists: Sequence[np.ndarray]) -> list[list[int]]:
    """Sorted neighbour lists of the conflict graph: the nonzero pattern of
    B B^T without its diagonal, B the block x index incidence matrix."""
    import scipy.sparse as sp

    n = len(indexlists)
    lists = [np.unique(np.asarray(ix).ravel()).astype(np.int64)
             for ix in indexlists]
    cols = np.concatenate(lists) if lists else np.zeros(0, np.int64)
    if cols.size == 0:
        return [[] for _ in range(n)]
    rows = np.repeat(np.arange(n), [ix.size for ix in lists])
    inc = sp.csr_array((np.ones(cols.size, np.int32), (rows, cols)),
                       shape=(n, int(cols.max()) + 1))
    gram = (inc @ inc.T).tocoo()
    off = gram.row != gram.col
    adj = sp.csr_array((np.ones(int(off.sum()), np.int8),
                        (gram.row[off], gram.col[off])), shape=(n, n))
    adj.sort_indices()
    ptr, nb = adj.indptr.tolist(), adj.indices.tolist()
    return [nb[ptr[v]:ptr[v + 1]] for v in range(n)]


def conflict_adjacency(indexlists: Sequence[np.ndarray]) -> list[set[int]]:
    """Adjacency sets of the conflict graph: an edge between every pair of
    blocks that share an output index."""
    return [set(nb) for nb in _neighbours(indexlists)]


def _dsatur(neighbours: list[list[int]]) -> np.ndarray:
    n = len(neighbours)
    colors = [-1] * n
    sat: list[set[int]] = [set() for _ in range(n)]
    degree = [len(nb) for nb in neighbours]
    # (-saturation, -degree, vertex): the heap's minimum is the vertex the
    # quadratic scan picks; entries whose saturation has since grown are stale
    heap = [(0, -degree[v], v) for v in range(n)]
    heapq.heapify(heap)
    while heap:
        negsat, _negdeg, v = heapq.heappop(heap)
        if colors[v] >= 0 or -negsat != len(sat[v]):
            continue
        used = sat[v]
        c = 0
        while c in used:
            c += 1
        colors[v] = c
        for u in neighbours[v]:
            if colors[u] < 0 and c not in sat[u]:
                sat[u].add(c)
                heapq.heappush(heap, (-len(sat[u]), -degree[u], u))
    return np.asarray(colors, dtype=np.int64)


def dsatur_color(adj: Sequence[set[int]]) -> np.ndarray:
    """DSATUR greedy coloring: highest saturation (distinct neighbour
    colors) first, ties by degree then lowest vertex id; each vertex takes
    the smallest free color.  Returns the color id per vertex (0-based)."""
    return _dsatur([list(a) for a in adj])


def color_blocks(indexlists: Sequence[np.ndarray]):
    """Group block ids into conflict-free colors: a tuple of int32 arrays,
    blocks within one color share no output index (span
    ``bsp.coloring``)."""
    with annotate("bsp.coloring", blocks=len(indexlists)) as span:
        assignment = _dsatur(_neighbours(indexlists))
        ncolors = int(assignment.max()) + 1 if assignment.size else 0
        span.set(colors=ncolors)
        return tuple(np.nonzero(assignment == c)[0].astype(np.int32)
                     for c in range(ncolors))


def validate_coloring(
    indexlists: Sequence[np.ndarray], colors: Sequence[np.ndarray]
) -> bool:
    """Check colors are a partition and each color is conflict-free."""
    seen: set[int] = set()
    for group in colors:
        used: set[int] = set()
        for b in group:
            b = int(b)
            if b in seen:
                return False
            seen.add(b)
            ids = set(np.asarray(indexlists[b]).ravel().tolist())
            if used & ids:
                return False
            used |= ids
    return len(seen) == len(indexlists)
