"""Boundary-element near field on the unit sphere: the generator of the
``bem_*`` configurations.

The structure depends on the configuration alone, never on the seed:

- ``n`` points of a Fibonacci lattice on the unit sphere;
- a cluster tree that splits each node's bounding box at the midpoint of its
  longest side until a leaf holds at most ``leaf_size`` points (an
  octree-style tree as FMM codes build it, so leaf sizes vary); the basis is
  leaf-sorted, so every leaf's index list is one contiguous range;
- two leaves are near, and get a dense block, when the distance between
  their bounding boxes is less than ``eta`` times the larger box diameter
  (admissibility); each off-diagonal pair is stored once.

The seed moves each point along the sphere by at most ``jitter`` times the
mean spacing ``h = sqrt(4 pi / n)`` after the structure is fixed, and draws
every right-hand side.  The operator is the second-kind equation of the
interior Dirichlet problem with a double-layer ansatz, ``(1/2 I - K) phi =
-f``, in a Nystrom discretisation with the equal weights ``w = 4 pi / n``
of the lattice.  On the unit sphere the double-layer kernel depends on the
distance alone, ``K(r) = exp(i k r) (i k r - 1) / (8 pi r)``, so the matrix
is (complex) symmetric: off the diagonal ``-w K(r)``, on it ``1/2`` less
``K`` integrated over the point's own patch, a disk of area ``w``
(``self_term``).  A real dtype takes the real part.  Values are computed on
the device in float64 / complex128 in batches of entries.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

# entries computed per batch on the device (complex128 values and their
# int64 indices: ~0.5 GB a batch)
BATCH_ENTRIES = 1 << 24


@dataclass(frozen=True)
class Structure:
    """The seed-independent part of a configuration: leaf-sorted points,
    leaf ranges ``[starts[l], starts[l] + sizes[l])`` and the near pairs
    ``pairs[p] = (i, j)``, ``i < j``."""

    points: np.ndarray  # [n, 3] float64, leaf-sorted
    starts: np.ndarray  # [L] int64
    sizes: np.ndarray  # [L] int64
    pairs: np.ndarray  # [P, 2] int64, i < j

    @property
    def n(self) -> int:
        return int(self.points.shape[0])

    @property
    def diag_entries(self) -> int:
        return int((self.sizes * self.sizes).sum())

    @property
    def off_entries(self) -> int:
        return int((self.sizes[self.pairs[:, 0]]
                    * self.sizes[self.pairs[:, 1]]).sum())


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1 - 2 * (i + 0.5) / n
    rho = np.sqrt(1 - z * z)
    return np.stack([rho * np.cos(phi), rho * np.sin(phi), z], axis=1)


def cluster_tree(points: np.ndarray, leaf_size: int) -> list:
    """Leaves in depth-first order (lower half first), each an array of
    point ids: split at the midpoint of the bounding box's longest side."""
    leaves, stack = [], [np.arange(points.shape[0])]
    while stack:
        ids = stack.pop()
        if ids.size <= leaf_size:
            leaves.append(ids)
            continue
        p = points[ids]
        lo, hi = p.min(axis=0), p.max(axis=0)
        axis = int(np.argmax(hi - lo))
        lower = p[:, axis] <= 0.5 * (lo[axis] + hi[axis])
        stack.append(ids[~lower])  # popped second
        stack.append(ids[lower])
    return leaves


def near_pairs(lo: np.ndarray, hi: np.ndarray, eta: float) -> np.ndarray:
    """``(i, j)``, ``i < j``, of the boxes whose distance is less than
    ``eta`` times the larger diameter."""
    diam = np.linalg.norm(hi - lo, axis=1)
    out = []
    for i in range(lo.shape[0] - 1):
        gap = np.maximum(0.0, np.maximum(lo[i + 1:] - hi[i], lo[i] - hi[i + 1:]))
        dist = np.linalg.norm(gap, axis=1)
        j = np.flatnonzero(dist < eta * np.maximum(diam[i], diam[i + 1:]))
        out.append(np.stack([np.full(j.size, i), j + i + 1], axis=1))
    return np.concatenate(out).astype(np.int64)


def structure(cfg: dict) -> Structure:
    pts = fibonacci_sphere(int(cfg["n"]))
    leaves = cluster_tree(pts, int(cfg["leaf_size"]))
    order = np.concatenate(leaves)
    sizes = np.array([lf.size for lf in leaves], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    lo = np.stack([pts[lf].min(axis=0) for lf in leaves])
    hi = np.stack([pts[lf].max(axis=0) for lf in leaves])
    return Structure(pts[order], starts, sizes,
                     near_pairs(lo, hi, float(cfg["eta"])))


def wavenumber(cfg: dict) -> float:
    """``k``: given, or from ``points_per_wavelength`` with the mean spacing
    ``h = sqrt(4 pi / n)``: ``k = 2 pi / (ppw h)``."""
    if "points_per_wavelength" in cfg:
        h = math.sqrt(4 * math.pi / int(cfg["n"]))
        return 2 * math.pi / (float(cfg["points_per_wavelength"]) * h)
    return float(cfg.get("k", 0.0))


def jittered_points(st: Structure, cfg: dict, seed: int,
                    device) -> torch.Tensor:
    """The points moved along great circles of the sphere, in a direction
    and by an arc drawn from ``seed``, at most ``jitter`` times the mean
    spacing ([n, 3] float64, on the unit sphere)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    h = math.sqrt(4 * math.pi / st.n)
    pts = torch.from_numpy(st.points).to(device)
    d = torch.randn(st.n, 3, generator=g, device=device, dtype=torch.float64)
    d = d - (d * pts).sum(dim=1, keepdim=True) * pts
    d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-30)
    t = torch.rand(st.n, 1, generator=g, device=device, dtype=torch.float64)
    arc = t * (float(cfg["jitter"]) * h)
    out = pts * torch.cos(arc) + d * torch.sin(arc)
    return out / out.norm(dim=1, keepdim=True)


def _entry_index(mi, mj, r0, c0, device):
    """Per entry of the blocks ``(mi[b] x mj[b]`` at rows ``r0[b]``, cols
    ``c0[b]``, row-major, block after block): its global row and column."""
    cnt = mi * mj
    bid = torch.repeat_interleave(torch.arange(cnt.numel(), device=device),
                                  cnt)
    off = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(int(cnt.sum()), device=device) - off[bid]
    return r0[bid] + local // mj[bid], c0[bid] + local % mj[bid]


def _batches(mi, mj, limit=BATCH_ENTRIES):
    """Ranges ``[b0, b1)`` of blocks holding at most ``limit`` entries (or
    one block)."""
    cnt = (mi * mj).cpu().numpy()
    b0, acc = 0, 0
    for b, c in enumerate(cnt):
        if acc and acc + c > limit:
            yield b0, b
            b0, acc = b, 0
        acc += int(c)
    if b0 < len(cnt):
        yield b0, len(cnt)


def weight(n: int) -> float:
    """The Nystrom weight of each point: the sphere's area over ``n``."""
    return 4 * math.pi / n


def self_term(n: int, k: float) -> complex:
    """The diagonal: ``1/2`` less the double-layer kernel integrated over a
    disk of radius ``a = sqrt(w / pi)``, ``(1/4) int_0^a exp(i k r) (i k r
    - 1) dr = (1/4) (a exp(i k a) - 2 (exp(i k a) - 1) / (i k))`` (``-a / 4``
    at ``k = 0``)."""
    a = math.sqrt(weight(n) / math.pi)
    if k == 0:
        return 0.5 + a / 4
    e = complex(math.cos(k * a), math.sin(k * a))
    return 0.5 - 0.25 * (a * e - 2 * (e - 1) / complex(0, k))


def kernel_values(pts, rows, cols, k: float, complex_: bool):
    """``-w K(r) = w exp(i k r) (1 - i k r) / (8 pi r)`` between
    ``pts[rows]`` and ``pts[cols]`` (float64: the real part, or
    complex128; 0 where ``rows == cols``)."""
    r = (pts[rows] - pts[cols]).norm(dim=1)
    same = rows == cols
    r = torch.where(same, torch.ones_like(r), r)
    scale = weight(pts.shape[0]) / (8 * math.pi * r)
    v = torch.complex(scale, -scale * k * r) * torch.polar(torch.ones_like(r), k * r)
    v = v if complex_ else v.real
    return torch.where(same, torch.zeros_like(v), v)


@dataclass
class Values:
    """The stored values of one seed, flat, block after block in the
    structure's order (diagonal leaves, then the pairs), in the stored
    dtype on the device; the points."""

    diag: torch.Tensor
    off: torch.Tensor
    points: torch.Tensor


STORED = {"float32": torch.float32, "complex64": torch.complex64}


def values(st: Structure, cfg: dict, seed: int, device) -> Values:
    dtype = STORED[cfg["dtype"]]
    complex_ = dtype.is_complex
    k = wavenumber(cfg)
    pts = jittered_points(st, cfg, seed, device)
    sizes = torch.from_numpy(st.sizes).to(device)
    starts = torch.from_numpy(st.starts).to(device)
    pi, pj = (torch.from_numpy(st.pairs[:, c]).to(device) for c in (0, 1))
    groups = {"diag": (sizes, sizes, starts, starts),
              "off": (sizes[pi], sizes[pj], starts[pi], starts[pj])}
    flat = {}
    for name, (mi, mj, r0, c0) in groups.items():
        parts = []
        for b0, b1 in _batches(mi, mj):
            rows, cols = _entry_index(mi[b0:b1], mj[b0:b1], r0[b0:b1],
                                      c0[b0:b1], device)
            v = kernel_values(pts, rows, cols, k, complex_)
            if name == "diag":
                c = self_term(st.n, k)
                v[rows == cols] = c if complex_ else c.real
            parts.append(v.to(dtype))
        flat[name] = torch.cat(parts)
    return Values(flat["diag"], flat["off"], pts)


def host_blocks(st: Structure, flat: np.ndarray, pairs: bool) -> list:
    """Views of a flat host buffer as the blocks, in order."""
    if pairs:
        mi, mj = st.sizes[st.pairs[:, 0]], st.sizes[st.pairs[:, 1]]
    else:
        mi = mj = st.sizes
    offs = np.concatenate([[0], np.cumsum(mi * mj)])
    return [flat[offs[b]:offs[b + 1]].reshape(int(mi[b]), int(mj[b]))
            for b in range(mi.size)]


def leaf_ranges(st: Structure) -> list:
    return [np.arange(s, s + m, dtype=np.int64)
            for s, m in zip(st.starts, st.sizes)]


def summary(st: Structure, cfg: dict) -> dict:
    """Sizes printed in set-up and recorded with the configuration."""
    item = torch.empty(0, dtype=STORED[cfg["dtype"]]).element_size()
    hist = np.histogram(st.sizes, bins=[1, 17, 33, 65, 97, 129])[0]
    stored = st.diag_entries + st.off_entries
    return {"n": st.n, "leaves": int(st.sizes.size),
            "leaf_size_histogram": {"1-16": int(hist[0]),
                                    "17-32": int(hist[1]),
                                    "33-64": int(hist[2]),
                                    "65-96": int(hist[3]),
                                    "97-128": int(hist[4])},
            "leaf_size_mean": float(st.sizes.mean()),
            "stored_blocks": int(st.sizes.size + st.pairs.shape[0]),
            "offdiagonal_blocks": int(st.pairs.shape[0]),
            "logical_nonzeros": st.diag_entries + 2 * st.off_entries,
            "stored_entries": stored,
            "stored_bytes": stored * item,
            "wavenumber": wavenumber(cfg)}


# -- the system under test ----------------------------------------------------

class System:
    """One seed's operator of the program under test, built from the
    generated blocks through the port's public constructor (host arrays),
    with the block-Jacobi preconditioner on demand and the inputs the
    reference needs."""

    def __init__(self, cfg: dict, seed: int, device, log):
        import blocksparse_tpu_torch as bt

        self.cfg, self.device = cfg, torch.device(device)
        self.dtype = STORED[cfg["dtype"]]
        self.phases = {}
        t = time.perf_counter()
        self.st = structure(cfg)
        self.phases["structure_s"] = time.perf_counter() - t
        log(f"sizes {summary(self.st, cfg)}")
        t = time.perf_counter()
        self.vals = values(self.st, cfg, seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases["values_s"] = time.perf_counter() - t
        t = time.perf_counter()
        diag = self.vals.diag.cpu().numpy()
        off = self.vals.off.cpu().numpy()
        self.ranges = leaf_ranges(self.st)
        self.phases["to_host_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.op = bt.SymmetricBlockMatrix(
            host_blocks(self.st, diag, False), self.ranges,
            host_blocks(self.st, off, True),
            [self.ranges[i] for i in self.st.pairs[:, 0]],
            [self.ranges[j] for j in self.st.pairs[:, 1]],
            (self.st.n, self.st.n), device=self.device,
            precision=cfg.get("precision", "highest"))
        self.phases["constructor_s"] = time.perf_counter() - t

    @property
    def n(self) -> int:
        return self.st.n

    def precond(self):
        """The port's ``BlockSparseMatrix`` of the inverted diagonal leaf
        blocks: with disjoint leaves, what ``precond.block_jacobi`` returns
        (each stored block inverted in double precision, cast back)."""
        import blocksparse_tpu_torch as bt

        t = time.perf_counter()
        st, dev = self.st, self.device
        T = int(st.sizes.max())
        sizes = torch.from_numpy(st.sizes).to(dev)
        zero = torch.zeros_like(sizes)
        rows, cols = _entry_index(sizes, sizes, zero, zero, dev)
        bid = torch.repeat_interleave(torch.arange(sizes.numel(), device=dev),
                                      sizes * sizes)
        wide = torch.complex128 if self.dtype.is_complex else torch.float64
        D = torch.zeros(sizes.numel(), T, T, dtype=wide, device=dev)
        D[bid, rows, cols] = self.vals.diag.to(wide)
        lf, i = (torch.arange(T, device=dev)[None, :]
                 >= sizes[:, None]).nonzero(as_tuple=True)
        D[lf, i, i] = 1  # identity in the padding
        inv = torch.linalg.inv(D)[bid, rows, cols].to(self.dtype).cpu().numpy()
        M = bt.BlockSparseMatrix(host_blocks(st, inv, False), self.ranges,
                                 self.ranges, (st.n, st.n), device=dev)
        self.phases["precond_s"] = time.perf_counter() - t
        return M

    def work(self, which: str) -> dict:
        """Logical entries of the operator ("S") or of the preconditioner
        ("M"): stored, logical, rows, cols, dtype."""
        st = self.st
        if which == "S":
            stored = st.diag_entries + st.off_entries
            logical = st.diag_entries + 2 * st.off_entries
        else:
            stored = logical = st.diag_entries
        return {"stored": stored, "logical": logical, "rows": st.n,
                "cols": st.n, "dtype": self.cfg["dtype"],
                "tier": self.cfg.get("precision", "highest")}

    def reference(self):
        return reference_of(self.cfg, self.st, self.vals.points)

    def free(self):
        """Drop the program's state (the points stay for the reference)."""
        self.op = None
        self.vals.diag = self.vals.off = None


def reference_of(cfg: dict, st: Structure, points: torch.Tensor):
    """The plain reference, from the points and the structure alone."""
    from gpubench.reference.bem import BemReference

    return BemReference(points, st.starts, st.sizes, st.pairs,
                        k=wavenumber(cfg), complex_=STORED[cfg["dtype"]].is_complex)


def setup(cfg: dict, seed: int, device, log) -> System:
    return System(cfg, seed, device, log)
