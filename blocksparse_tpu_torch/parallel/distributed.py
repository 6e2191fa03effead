"""Distributed block-sparse operators over a device mesh.

Counterpart of ``blocksparse_tpu/parallel/distributed.py``: 1-D **block-row
partitioning** over a :class:`~.mesh.Mesh`, each shard's blocks run
through the port's bucket kernels.  Per shard and product:

  1. **Forward halo**: per active ring distance d, shard s packs the
     128-element x chunks that shard (s + d) % S needs (``index_select`` on
     ``x_local`` viewed ``[per / G, G, r]``, the send table of the halo plan,
     ``partition.plan_halo``) into that shard's ``[x_local ++ halo]``
     buffer.  Only those chunks move: exchanged bytes scale with the block
     structure's shard overlap, not with N.
  2. **Local blocks** ("loc" groups: rows and columns all in the owner's
     ranges) run on ``x_local`` while the halo is in flight: on the card the
     exchange runs on a second CUDA stream, and the compute stream waits
     for it before step 3.
  3. **Halo blocks** ("rem" groups) run on ``[x_local ++ halo]`` and add
     contributions to rows of other shards into the halo region of
     ``[y_local ++ halo]``.
  4. **Reverse halo**: each halo region goes back to its owners over the
     same plan, who add it in with ``index_add_`` over G-chunks.

Each shard's groups run in the port's kernels: per ``(kind, loc | rem)``
one launch of kernel B1 (``fused_spmm.multi_block_apply``) over a
``BucketTable`` of its chunked groups and one launch of B9's element pass
(``mask_select.element_apply``) over its element groups, through their
autograd forms, so the in-process path differentiates in ``x``.  The
stacked ``(values, rowtab, coltab, chunk)`` of ``partition.stack_operand``
has the table's form; a shard's table drops the all-zero padding slots of
the ``[S, nbmax]`` stack.  The tables' sentinels (``Lin`` / ``Lout``, or
``Lin // C`` / ``Lout // C``) lie just past the buffers, where the kernels
read zero and drop writes, so the buffers are exactly ``Lin`` / ``Lout``
long.  Modes: a general operator's product is the forward mode, its
transpose the transpose mode; a symmetric operator keeps one merged plan
and one copy of each off-diagonal block, whose groups run the symmetric
mode (the mirror from one read of the values) in every product, while its
diagonal groups take the transpose mode under transpose.  ``conj`` is the
kernels' conjugate mode.

Transports (the plan and the ring are the same for all three):

- shards on one device: the pack writes into a slice of the receiving
  shard's buffer, with no other copy;
- shards on different devices of this process: ``copy_`` across devices,
  non-blocking;
- shards of other processes (a mesh whose entries name several ranks):
  ``torch.distributed.batch_isend_irecv`` (gloo for CPU tensors, NCCL for
  CUDA ones).  Every rank passes the same full ``x`` (the JAX
  ``replicate`` contract) and gets the full ``y``, all-gathered.  Such a
  product does not differentiate: an operand that requires grad raises.

``D @ x`` takes the full ``x`` on any device and returns the full ``y`` on
the mesh's first device of this process (:attr:`device`).
:meth:`apply_local` serves callers that keep their vectors sharded.

``rhs_axis`` names a second mesh axis: ``D @ X`` with 2-D ``X`` pads r to
a multiple of that axis' size R and runs one independent row ring per
group of r / R columns, on that column's mesh entries.  Vectors, and every
product without ``rhs_axis``, run the ring of the first column.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core.operator import (
    AdjointOperator,
    ConjOperator,
    LinearOperator,
    TransposeOperator,
    as_tensor,
)
from ..formats.block_sparse import promoted_apply
from ..formats.symmetric import SymmetricBlockMatrix
from ..ops.kernels.fused_spmm import BucketTable, multi_fused_apply
from ..ops.kernels.mask_select import element_fused_apply
from .mesh import Mesh, process_rank
from .partition import G, HaloPlan, collect_reads, partition_rows, plan_halo, \
    stack_operand

__all__ = ["DistributedBlockOperator", "distribute"]

_KEYS = ("loc", "rem")


@dataclass(frozen=True)
class _Meta:
    """The static descriptor of a distributed operator (the JAX ``_Meta``
    without its mesh)."""

    axis: str
    shape: tuple[int, int]
    dtype: torch.dtype
    precision: str | None
    sym: bool
    rows_per: int
    cols_per: int
    Hr: int  # row-space halo G-chunks per shard
    Hc: int  # col-space halo G-chunks per shard
    row_dists: tuple[int, ...]
    col_dists: tuple[int, ...]
    # per part: "diag" | "off" | "gen"; per bucket: (loc_chunk, rem_chunk),
    # -1 = group absent, 1 = element tables, C > 1 = chunk tables.
    part_kinds: tuple[str, ...]
    part_chunks: tuple[tuple[tuple[int, int], ...], ...]
    rhs_axis: str | None = None


def _resolve(op):
    """Unwrap lazy wrappers -> (base, transpose, conj) flags."""
    tr = cj = False
    while isinstance(op, (TransposeOperator, AdjointOperator, ConjOperator)):
        if isinstance(op, TransposeOperator):
            tr = not tr
        elif isinstance(op, AdjointOperator):
            tr = not tr
            cj = not cj
        else:
            cj = not cj
        op = op.op
    return op, tr, cj


@dataclass
class _Shard:
    """One shard's tables on one device: per ``(kind, key)`` its B1 table
    (chunked groups) and its element table (B9), each None where empty, and
    this shard's row of every send table (int64, per distance)."""

    groups: list  # [(kind, key, chunked BucketTable | None, element | None)]
    row_send: list
    col_send: list


def _shard_tables(s: int, meta: _Meta, parts, device) -> list:
    """Shard ``s``'s groups as :class:`BucketTable` s on ``device``, the
    padding slots (rows all sentinel) dropped."""
    Lr = meta.rows_per + meta.Hr * G
    groups = []
    for kind, buckets, chunks in zip(meta.part_kinds, parts,
                                     meta.part_chunks):
        for k, key in enumerate(_KEYS):
            chunked, elem = [], []
            for grp, ck in zip(buckets, chunks):
                if grp[k] is None:
                    continue
                values, rowtab, coltab = (a[s] for a in grp[k])
                c = int(ck[k])
                live = (rowtab < Lr // c).any(axis=1)
                if not live.any():
                    continue
                vals = torch.from_numpy(np.ascontiguousarray(values[live]))
                entry = (vals.to(meta.dtype).to(device),
                         _int32(rowtab[live], device),
                         _int32(coltab[live], device), c)
                (chunked if c > 1 else elem).append(entry)
            if chunked or elem:
                groups.append((kind, key,
                               BucketTable(chunked) if chunked else None,
                               BucketTable(elem) if elem else None))
    return groups


def _int32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


class DistributedBlockOperator(LinearOperator):
    """Block-row-sharded operator bound to the ``axis`` of a :class:`Mesh`.

    Layouts are reused from the source format (no rebuild).  ``_arrays``
    holds the stacked host arrays, as the JAX operator's leaves: ``(row
    send tables, col send tables, parts)``, a part per layout, per bucket a
    ``(loc, rem)`` pair of ``(values, rowtab, coltab)`` or None; each shard
    of this process stages its own slice of them on its device.
    """

    def __init__(self, op: LinearOperator, mesh: Mesh, axis: str = "rows",
                 rhs_axis: str | None = None):
        base, tr, cj = _resolve(op)
        if tr or cj:
            raise ValueError(
                "construct from the base operator and wrap lazily: "
                "distribute(A).T instead of distribute(A.T)"
            )
        _check_axes(mesh, axis, rhs_axis)
        S = mesh.shape[axis]
        m, n = map(int, base.shape)
        sym = isinstance(base, SymmetricBlockMatrix)
        if sym:
            layouts = [base._dlayout, base._olayout]
            kinds = ["diag", "off"]
        else:
            layouts = [base._layout]
            kinds = ["gen"]

        part = partition_rows(m, S)
        rows_per = part.shard_rows
        cols_per = partition_rows(n, S).shard_rows
        if sym:
            assert m == n and rows_per == cols_per
            # one merged plan serves rows and cols (square, same partition)
            needed = [set() for _ in range(S)]
            for lay in layouts:
                for side in ("rows", "cols"):
                    for s, got in enumerate(
                        collect_reads(lay, part, rows_per, cols_per, side)
                    ):
                        needed[s] |= got
            row_halo = col_halo = plan_halo(needed, S, rows_per)
        else:
            lay = layouts[0]
            row_halo = plan_halo(
                collect_reads(lay, part, rows_per, cols_per, "rows"),
                S, rows_per,
            )
            col_halo = plan_halo(
                collect_reads(lay, part, rows_per, cols_per, "cols"),
                S, cols_per,
            )

        parts, chunks = [], []
        for lay in layouts:
            bks, cks = [], []
            for g in stack_operand(lay, part, cols_per, row_halo, col_halo):
                present = [g[key]["values"].size > 0 for key in _KEYS]
                bks.append(tuple(
                    (g[key]["values"], g[key]["rowtab"], g[key]["coltab"])
                    if p else None for key, p in zip(_KEYS, present)))
                cks.append(tuple(int(g[key]["chunk"]) if p else -1
                                 for key, p in zip(_KEYS, present)))
            parts.append(tuple(bks))
            chunks.append(tuple(cks))
        meta = _Meta(
            axis=axis, shape=(m, n), dtype=base.dtype,
            precision=getattr(base, "_precision", "highest"), sym=sym,
            rows_per=rows_per, cols_per=cols_per, Hr=row_halo.halo_chunks,
            Hc=col_halo.halo_chunks, row_dists=row_halo.dists,
            col_dists=col_halo.dists, part_kinds=tuple(kinds),
            part_chunks=tuple(chunks), rhs_axis=rhs_axis,
        )
        self._setup(mesh, meta, row_halo, col_halo,
                    (row_halo.send_idx, col_halo.send_idx, tuple(parts)))

    @classmethod
    def from_arrays(cls, mesh: Mesh, meta: _Meta, row_halo: HaloPlan,
                    col_halo: HaloPlan, arrays) -> "DistributedBlockOperator":
        """An operator over given plans and stacked arrays, as they are (the
        carrier of ``interop/convert.py::from_reference``)."""
        _check_axes(mesh, meta.axis, meta.rhs_axis)
        if mesh.shape[meta.axis] != row_halo.S:
            raise ValueError(f"the arrays are stacked for {row_halo.S} shards;"
                             f" the mesh's {meta.axis!r} axis has "
                             f"{mesh.shape[meta.axis]}")
        obj = object.__new__(cls)
        obj._setup(mesh, meta, row_halo, col_halo, arrays)
        return obj

    def _setup(self, mesh, meta, row_halo, col_halo, arrays) -> None:
        self.mesh, self._meta = mesh, meta
        self.row_halo, self.col_halo = row_halo, col_halo
        self._arrays = arrays
        order = [mesh.axis_names.index(meta.axis)] + [
            i for i, name in enumerate(mesh.axis_names) if name != meta.axis]
        # [S, R]: rows along the first axis, RHS column groups the second
        self._devs = np.transpose(mesh.devices, order).reshape(
            mesh.shape[meta.axis], -1)
        self._ranks = np.transpose(mesh.ranks, order).reshape(
            self._devs.shape)
        if meta.rhs_axis is None and self._devs.shape[1] > 1:
            self._devs, self._ranks = self._devs[:, :1], self._ranks[:, :1]
        self._rank = process_rank()
        local = [dev for dev, rank in zip(self._devs.flat, self._ranks.flat)
                 if rank == self._rank]
        if not local:
            raise ValueError(f"rank {self._rank} holds no entry of {mesh}")
        self._device = local[0]
        row_send, col_send, parts = arrays
        self._send_host = {"row_send": row_send, "col_send": col_send}
        self._shards = {}
        for (s, _j), dev in np.ndenumerate(self._devs):
            if self._ranks[s, _j] != self._rank or (s, dev) in self._shards:
                continue
            self._shards[(s, dev)] = _Shard(
                _shard_tables(s, meta, parts, dev),
                [torch.from_numpy(t[s].astype(np.int64)).to(dev)
                 for t in row_send],
                [torch.from_numpy(t[s].astype(np.int64)).to(dev)
                 for t in col_send])
        self._streams = {}

    # -- LinearOperator surface ----------------------------------------------
    @property
    def shape(self):
        return self._meta.shape

    @property
    def dtype(self):
        return self._meta.dtype

    @property
    def device(self) -> torch.device:
        """Where products return their result: this process's first mesh
        device."""
        return self._device

    @property
    def S(self) -> int:
        return int(self._devs.shape[0])

    @property
    def exchanged_bytes_per_call(self) -> int:
        """Static halo traffic per product (r=1, f32), summed over shards --
        the number the tests compare against the O(N) full all_gather this
        plan replaces."""
        b = self.row_halo.exchanged_bytes_per_call
        if not self._meta.sym:
            b += self.col_halo.exchanged_bytes_per_call
        return b

    def tables(self) -> dict:
        """Kernel launches of one ring (a product without ``rhs_axis``) in
        this process: ``{"B1": chunked tables, "B9 element": element
        tables}`` over the shards of the first column, and of them those
        in the symmetric mode (``"B1 sym"``, ``"B9 element sym"``: a
        symmetric operator's off-diagonal groups)."""
        got = {"B1": 0, "B1 sym": 0, "B9 element": 0, "B9 element sym": 0}
        for s in range(self.S):
            if self._ranks[s, 0] == self._rank:
                for kind, _key, ch, el in self._shards[
                        (s, self._devs[s, 0])].groups:
                    for name, table in (("B1", ch), ("B9 element", el)):
                        got[name] += table is not None
                        got[f"{name} sym"] += (table is not None
                                               and kind == "off")
        return got

    def _apply(self, x, transpose, conj):
        x = as_tensor(x).to(self._device)
        if x.requires_grad and self.mesh.multiprocess:
            raise NotImplementedError(
                "a product over several processes does not differentiate")
        return promoted_apply(self._apply_rings, x, self._device, self.dtype,
                              transpose, conj)

    def _spaces(self, transpose: bool) -> tuple:
        """(in_per, out_per, Hin, Hout, in_dists, out_dists, in send side,
        out send side): the gather space of the input and the scatter space
        of the output in this mode (symmetric: one merged space)."""
        mt = self._meta
        tr_in = mt.sym or transpose
        tr_out = mt.sym or not transpose
        return (mt.rows_per if tr_in else mt.cols_per,
                mt.rows_per if tr_out else mt.cols_per,
                mt.Hr if tr_in else mt.Hc, mt.Hr if tr_out else mt.Hc,
                mt.row_dists if tr_in else mt.col_dists,
                mt.row_dists if tr_out else mt.col_dists,
                "row_send" if tr_in else "col_send",
                "row_send" if tr_out else "col_send")

    def _apply_rings(self, x, transpose: bool, conj: bool):
        m, n = self.shape
        in_len, out_len = (m, n) if transpose else (n, m)
        in_per = self._spaces(transpose)[0]
        vec = x.ndim == 1
        xl = x[:, None] if vec else x
        r = xl.shape[1]
        pad = self.S * in_per - in_len
        if pad:
            xl = torch.cat([xl, xl.new_zeros((pad, r))])
        R = self._devs.shape[1] if (self._meta.rhs_axis and not vec) else 1
        rg = -(-r // R)
        if rg * R != r:
            xl = torch.cat([xl, xl.new_zeros((xl.shape[0], rg * R - r))], 1)
        outs = [self._ring(xl[:, j * rg:(j + 1) * rg].contiguous(), j,
                           transpose, conj) for j in range(R)]
        y = (outs[0] if R == 1 else torch.cat(outs, 1))[:out_len, :r]
        return y[:, 0] if vec else y

    def apply_local(self, x_local: dict, *, transpose: bool = False,
                    conj: bool = False) -> dict:
        """The product on sharded vectors: ``x_local`` maps each shard s of
        this process (first column) to its ``[per]`` or ``[per, r]`` slice
        of the padded input on its device; returns the same for the output
        (``per`` the shard size of the input / output space)."""
        first = next(iter(x_local.values()))
        vec = first.ndim == 1
        xs = {s: v[:, None] if vec else v for s, v in x_local.items()}
        ys = self._ring_local(xs, 0, transpose, conj)
        return {s: y[:, 0] if vec else y for s, y in ys.items()}

    # -- one ring ------------------------------------------------------------
    def _ring(self, xpad, col: int, transpose: bool, conj: bool):
        """The product of one column group: ``xpad`` the padded input
        ``[S * in_per, rg]``; returns ``[S * out_per, rg]`` on
        :attr:`device`."""
        in_per = self._spaces(transpose)[0]
        xs = {s: xpad[s * in_per:(s + 1) * in_per].to(
                  self._devs[s, col], non_blocking=True)
              for s in range(self.S) if self._ranks[s, col] == self._rank}
        ys = self._ring_local(xs, col, transpose, conj)
        if not self.mesh.multiprocess:
            return torch.cat([ys[s].to(self._device) for s in range(self.S)])
        return self._gather(ys, col, xpad.dtype, xpad.shape[1], transpose)

    def _ring_local(self, xs: dict, col: int, transpose: bool,
                    conj: bool) -> dict:
        """Steps 1-4 for the shards of this process in column ``col``:
        ``xs`` maps shard -> ``x_local`` [in_per, r] on its device; returns
        shard -> ``y_local`` [out_per, r]."""
        (in_per, out_per, Hin, Hout, in_dists, out_dists, in_side,
         out_side) = self._spaces(transpose)
        Lin, Lout = in_per + Hin * G, out_per + Hout * G
        devs = {s: self._devs[s, col] for s in xs}
        shards = {s: self._shards[(s, devs[s])] for s in xs}
        first = next(iter(xs.values()))
        r, dtype = first.shape[1], first.dtype
        xh = {}
        for s, x in xs.items():
            if Lin == in_per:
                xh[s] = x
                continue
            xh[s] = torch.empty((Lin, r), dtype=dtype, device=devs[s])
            xh[s][:in_per].copy_(x)
        wait = self._forward_halo(xs, xh, shards, devs, col, in_dists,
                                  in_side, in_per, r)
        acc = {s: torch.zeros((Lout, r), dtype=dtype, device=devs[s])
               for s in xs}
        for s in xs:  # 2. local blocks, while the halo is in flight
            self._consume(shards[s], "loc", xs[s], acc[s][:out_per],
                          transpose, conj)
        wait()
        for s in xs:  # 3. halo blocks on [x_local ++ halo]
            self._consume(shards[s], "rem", xh[s], acc[s], transpose, conj)
        self._reverse_halo(acc, shards, devs, col, out_dists, out_side,
                           out_per, r)
        return {s: a[:out_per] for s, a in acc.items()}

    @staticmethod
    def _consume(shard, key, x, out, transpose, conj) -> None:
        """``out`` (an accumulator or a view of one) += the ``key`` groups
        of ``shard`` applied to ``x``, in place: per group one B1 launch
        over its chunked table and one B9 element pass over its element
        table."""
        for kind, k, chunked, elem in shard.groups:
            if k != key:
                continue
            symmetric = kind == "off"
            tr = transpose and not symmetric
            for table, launch in ((chunked, multi_fused_apply),
                                  (elem, element_fused_apply)):
                if table is not None:
                    out = launch(table, x, out=out, transpose=tr,
                                 symmetric=symmetric, conj=conj)

    # -- transports ----------------------------------------------------------
    def _side(self, dev):
        """The exchange's CUDA stream on ``dev`` (made at first use), or
        None on the CPU."""
        if dev.type != "cuda":
            return None
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(device=dev)
        return self._streams[dev]

    def _peer(self, s: int, col: int):
        """Shard ``s``'s rank where another process holds it, else None."""
        rank = int(self._ranks[s, col])
        return None if rank == self._rank else rank

    def _forward_halo(self, xs, xh, shards, devs, col, dists, side_name,
                      in_per, r):
        """Step 1: pack every round's chunks into the receivers' buffers
        (on the side streams on the card; P2P ops for other processes).
        Returns the wait to call before the halo blocks."""
        if not dists:
            return lambda: None
        sides = {dev: self._side(dev) for dev in set(devs.values())}
        ops, offset = [], in_per
        with contextlib.ExitStack() as on_sides:
            # every pack, and the P2P ops (NCCL orders them after the
            # current stream's work), on each device's side stream
            for dev, side in sides.items():
                if side is not None:
                    side.wait_stream(torch.cuda.current_stream(dev))
                    on_sides.enter_context(torch.cuda.stream(side))
            for k, d in enumerate(dists):
                E = self._send_host[side_name][k].shape[1]
                seg = slice(offset, offset + E * G)
                for s in range(self.S):
                    t = (s + d) % self.S
                    if s in xs:
                        idx = getattr(shards[s], side_name)[k]
                        x3 = xs[s].view(in_per // G, G, r)
                        if t in xh:
                            _pack(x3, idx, xh[t][seg].view(E, G, r))
                        else:
                            ops.append(_p2p("isend", x3.index_select(0, idx),
                                            self._peer(t, col)))
                    elif t in xh:
                        ops.append(_p2p("irecv", xh[t][seg],
                                        self._peer(s, col)))
                offset += E * G
            reqs = _batch(ops)
        for s in xs:
            side = sides[devs[s]]
            if side is not None:
                xs[s].record_stream(side)
                xh[s].record_stream(side)

        def wait():
            for req in reqs:
                req.wait()
            for dev, side in sides.items():
                if side is not None:
                    torch.cuda.current_stream(dev).wait_stream(side)

        return wait

    def _reverse_halo(self, acc, shards, devs, col, dists, side_name,
                      out_per, r):
        """Step 4: every halo region of ``acc`` back onto its owners, who
        add it in over G-chunks."""
        ops, pending, offset = [], [], out_per
        # index_add_ keeps its source for the backward, and the owner's own
        # adds bump the version of the accumulator a local halo views, even
        # one that needs no grad itself (a shard with no blocks)
        keep = torch.is_grad_enabled() and any(
            a.requires_grad for a in acc.values())
        for k, d in enumerate(dists):
            E = self._send_host[side_name][k].shape[1]
            seg = slice(offset, offset + E * G)
            for t in range(self.S):
                src = (t + d) % self.S
                if t in acc:
                    idx = getattr(shards[t], side_name)[k]
                    if src in acc:
                        recv = acc[src][seg].to(devs[t], non_blocking=True)
                        if keep:
                            recv = recv.clone()
                    else:
                        recv = acc[t].new_empty((E * G, r))
                        ops.append(_p2p("irecv", recv, self._peer(src, col)))
                    pending.append((t, idx, recv))
                elif src in acc:
                    ops.append(_p2p("isend", acc[src][seg].contiguous(),
                                    self._peer(t, col)))
            offset += E * G
        for req in _batch(ops):
            req.wait()
        for t, idx, recv in pending:
            acc[t][:out_per].view(out_per // G, G, r).index_add_(
                0, idx, recv.view(-1, G, r))

    def _gather(self, ys, col, dtype, r, transpose):
        """The full ``[S * out_per, r]`` output on every rank: each rank's
        shards of column ``col``, all-gathered (padded to the largest
        count of any rank)."""
        import torch.distributed as dist

        out_per = self._spaces(transpose)[1]
        holders = [int(v) for v in self._ranks[:, col]]
        world = dist.get_world_size()
        per_rank = [[s for s in range(self.S) if holders[s] == q]
                    for q in range(world)]
        kmax = max(len(p) for p in per_rank)
        buf = torch.zeros((kmax, out_per, r), dtype=dtype,
                          device=self._device)
        for i, s in enumerate(per_rank[self._rank]):
            buf[i] = ys[s]
        got = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(got, buf)
        y = buf.new_empty((self.S * out_per, r))
        for q, shards in enumerate(per_rank):
            for i, s in enumerate(shards):
                y[s * out_per:(s + 1) * out_per] = got[q][i]
        return y

    def __repr__(self):
        mt = self._meta
        return (
            f"DistributedBlockOperator(shape={mt.shape}, S={self.S}, "
            f"sym={mt.sym}, halo_chunks=({mt.Hr},{mt.Hc}))"
        )


def _check_axes(mesh: Mesh, axis: str, rhs_axis) -> None:
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} not in mesh axes {tuple(mesh.shape)}")
    if rhs_axis is not None and rhs_axis not in mesh.shape:
        raise ValueError(
            f"rhs_axis {rhs_axis!r} not in mesh axes {tuple(mesh.shape)}"
        )
    if rhs_axis == axis:
        raise ValueError("rhs_axis must differ from the row axis")


def _pack(x3, idx, dst) -> None:
    """``dst = x3[idx]``: straight into ``dst`` where nothing records a
    gradient and the devices agree, else through a copy."""
    if x3.device == dst.device and not (torch.is_grad_enabled()
                                        and x3.requires_grad):
        torch.index_select(x3, 0, idx, out=dst)
    else:
        dst.copy_(x3.index_select(0, idx), non_blocking=True)


def _p2p(kind: str, tensor, peer: int):
    import torch.distributed as dist

    op = dist.isend if kind == "isend" else dist.irecv
    return dist.P2POp(op, tensor, peer)


def _batch(ops) -> list:
    if not ops:
        return []
    import torch.distributed as dist

    return dist.batch_isend_irecv(ops)


def distribute(op: LinearOperator, mesh: Mesh, axis: str = "rows", **kw):
    """Shard ``op`` block-row-wise over ``mesh[axis]``.

    Lazy wrappers are resolved and re-applied on top of the distributed
    base operator, so ``distribute(A.T) @ x == distribute(A).T @ x`` with a
    single copy of A either way.

    ``rhs_axis=`` names a second mesh axis that shards SpMM RHS columns
    (2-D block-rows x RHS-columns mesh): matrix data replicates across it,
    each RHS column group runs its own independent halo ring.  SpMV and
    1-D inputs ignore it.
    """
    base, tr, cj = _resolve(op)
    D = DistributedBlockOperator(base, mesh, axis, **kw)
    if tr and cj:
        return AdjointOperator(D)
    if tr:
        return TransposeOperator(D)
    if cj:
        return ConjOperator(D)
    return D
