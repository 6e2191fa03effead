#!/usr/bin/env python3
"""Smoke run of the PyTorch port (blocksparse_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --transposes   # B2's transposed products alone
    python3 chip_smoke.py --spmv         # the r = 1 products alone
    python3 chip_smoke.py --solve        # phase 12 (the BEM solve) alone
    python3 chip_smoke.py --complex      # phase 13 (the complex BEM) alone
    python3 chip_smoke.py --options      # phase 14 (options, dtypes, interop)
    python3 chip_smoke.py --distributed  # phase 15 (the distributed layer)
    python3 chip_smoke.py --mesh         # phase 15's transports across cards
    python3 chip_smoke.py --autotune     # phase 16 (the route autotuner)
    python3 chip_smoke.py --colored      # the colored element route alone

Builds the port's CUDA kernels from ``blocksparse_tpu_torch/csrc`` and runs:

  1. each kernel against its plain PyTorch version on the card (B1: forward,
     transpose, symmetric x f32/f64 x r in {1, 64, 200}, one bucket per
     launch and, over every chunked bucket of a layout plus one with chunk
     ids past n, in one multi-bucket launch, also against the sum of
     one-bucket launches; B9's element pass: the same modes and dtypes, r
     in {1, 64}, on element buckets with sentinel lanes and repeated rows,
     at f32 r = 1 also against the per-bucket chain of its one-call gather
     and scatter-add; B1 (one-bucket and multi-bucket, the latter also
     against the sum of one-bucket launches) and B9's element pass at
     complex64 / complex128 x forward, transpose, symmetric x conj off / on
     x r in {1, 64}; the r = 1 row-stream body of B1 and of B9's element
     pass (``csrc/row_stream.cuh``), launched directly, against its plain
     version and the tile core, every stored / compute pair x mode x conj,
     on 8-row chunked tiles, 64 x 512 and 64 x 1536 blocks, one block, an
     empty bucket, rows of 27 values and of one, a 96-row tile and
     single-row element blocks; B2: its prologue
     (hi bit-equal to the plain tf32(X)^T, hi + lo == X, one launch for P
     products), forward and transpose x r in {6, 8, 64, 128, 300, 302}
     (r % 4 != 0: the transpose's atomicAdd epilogue) x both
     tensor-core tiers on a plan of 8-row slots, one of 48-row slots (not a
     multiple of 32) and one of 128-row slots, the transpose also at P in
     {2, 4} (batched_mm's dX) against its plain version and against P
     single transposes, with inf / NaN in the rows of X no window covers,
     and against the forward on the plan of the transposed layout, its
     launch geometry on known shapes; its
     wgmma forward against B4's forward instance at P = 1; B3: symmetric
     and adjoint x r in
     {32, 64, 128, 300} x both plans x both tensor-core tiers ("highest":
     3xTF32, None: one TF32 pass); B9: element gather and scatter-add with duplicate
     and sentinel indices; B5: plain, transposed, fused mirror plans with
     shifted grids (one of five slabs), a plan whose last segment runs past
     ncols and a mirror plan whose 408 compact chunks take B5's direct
     mode, each at one tile per block, the whole stream in one block,
     ranges that split slabs and row chunks over fewer blocks than slabs,
     and the kernel's own geometry (its duality check: the first two
     against each other); B8: plain and mirror slab plans, at one tile per
     warp (every row sum an atomic add) against 16 (sums carried in
     registers); B4: forward, P in
     {2, 4} x r in {8, 64, 128, 264}, and against P launches of B2; B6: on
     B5's panel plans, P in {2, 5}, at 1 against 16 tiles per
     warp and against P launches of B5 (B4 at both tiers, its duality with
     B2 at "highest"); B7: modes f, t, m and a on B2's plan, a plan with
     G = 1 whose row windows run past n, B3's plans, a symmetric plan of
     64 x 2048 slots and a copy of it with all-zero row tiles, an all-zero
     slot and a slot of sentinel chunks, each at one tile per block, the
     whole live row-tile table in one block and the kernel's geometry
     (printed), and against B2 (f, t) / B3 (m, a) at r = 1 on the same
     plan; then x = inf at the rows only all-zero row tiles face (modes t
     and a) against scipy over the blocks; B10: v2 plans at seg 8, 16 and
     32, plain, transposed, fused mirror (two), a mirror plan of its
     direct mode and one with a last segment past ncols, at one tile per
     block, the whole stream in one block, ranges that split slabs and its
     own geometry (printed), every seg driving the three modes; B9's owner
     mode (its two passes), every stored / compute pair x forward,
     transpose (x conj for complex values) x r in {1, 3, 64, 128}, two
     launches bit-equal; B9's colored rounds (``csrc/colored_rounds.cu``)
     against the plain rounds on the same scratch, every compute dtype x r
     in {1, 3, 33, 64} x one and 64 colors, with sentinel targets and rows
     no color reaches, two launches bit-equal; the colored element route
     (products pass + rounds) against its plain version, every stored /
     compute pair x forward, transpose, symmetric (x conj) x r in {1, 64}
     (the one-read products at r = 1), two products bit-equal; B1's
     tensor-core instances (complex64, float64,
     complex128, bf16 -> float32), forward, transpose, symmetric (x conj
     for complex values) x r in {2, 16, 64, 200}, against their plain
     version and the FMA instance on a table with sentinel chunks and the
     deepest block the rule admits, and the bf16 and complex64 instances'
     error by contraction depth (64 to 8192) against a float64 product,
     which sets their depth caps;
  2. the flagship operator (4096^2, 200 contiguous 64x64 f32 blocks, r = 64):
     a constructor without ``device=`` lands on the card; kernels against
     plain versions at its shapes, then the main path once
     with the counters reset (A @ X, A @ x, A.T @ x, A.H @ X, axpby,
     (A @ A) @ x; its r = 1 products stay on the bucket route, one B1
     launch each, as the JAX decision says) against float64 scipy, and
     gradients;
  3. the real size (n = 8192, 2000 contiguous 128x128 f32 blocks): SpMV
     through the stream route (one B5 launch) and SpMM r = 128 (B2)
     against the float64 plain route, the bucket route (one B1 launch, its
     backward one more) driven explicitly, all timed eager and replayed
     from a CUDA graph; B2 at
     precision=None (a second operator built with it) and A.T @ X at both
     tiers (one prologue and one transposed launch each), timed the same
     way, and the parts: the prologue alone, the bucket's forward, B4's
     forward instance at P = 1 on the same plan, the transposed kernel alone
     with its grid, X^T and output-add bytes as the plan gives them, and
     the host time per call;
  4. the symmetric flagship (config-2 recipe, 4096^2, 48 diagonal + 160
     off-diagonal blocks): B1's symmetric pass and B3 against their plain
     versions, the main path with exact counts (B3 on every r > 1 product,
     one B5 launch on the fused mirror plan per r = 1 product), the bucket
     route (one B1 launch per layout, the off-diagonal's symmetric)
     driven explicitly, and gradients; then the same recipe with scattered
     groups, whose r = 1 products no stream plan takes, as a main path:
     under the colored schedule its element buckets run the colored
     element route (per pass a products launch and one B9 rounds launch;
     no one-call gather or scatter-add, forward or backward), under
     "serial" one B9 element pass per layout, with exact counts; S @ X at
     r = 64 through the bucket route; the cell at r = 1 and 64 timed eager
     and from a CUDA graph: the colored route, the serial route, the old
     chain (the per-bucket one-call gathers, einsums and torch rounds) and
     the expanded CSR call; the rounds and the products pass each alone;
  5. the symmetric real size (config-2 recipe x8, n = 32768): construction
     split (layout, coloring, panel plan, slab plan, patch plan), B9 against
     its plain version on every element bucket, SpMV through B5 on the plan
     the H100 rule picks (the fused mirror plan; both candidate plans timed
     through B5, the measured mirror factor printed beside the rule's
     constant) and its gradient timed, and SpMM r = 128 (B3) against the
     float64 plain route, the bucket
     route (at most two B1 launches and two B9 element passes, exact
     counts, with its gradient; which passes run colored plans printed),
     all timed eager and from a CUDA graph, and the bucket route's device
     time split (each pass in one launch beside one launch per
     bucket), the element pass beside its bound and a CSR library call;
     B9's one-call kernels also on 2^20 indices; then the real-size
     colored cell (the same recipe with scattered groups, both passes on
     colored plans) timed as phase 4's scattered cell;
     B3's owner tables, and B3 at precision=None (a second operator), in
     its adjoint mode (the dX of S @ X) and with an empty owner table (its
     forward blocks alone), timed;
  6. the VBCRS flagship (config-3 recipe, n = 4096, seed 9, granularity
     (8, 128)): B5 against its plain version, V @ x, V.T @ x, V.H @ X
     (r = 64), axpby and (V @ V) @ x against float64 scipy with exact
     counts, and the gradient of V @ x;
  7. the VBCRS real size (the same recipe at n = 32768): construction split
     (layout, panel plan, slab plan), SpMV through B5 and its gradient, the
     bucket route (one B1 launch, and its backward) and the plain route,
     eager and graph, and
     B8 on the operand's slab plan
     against its plain version, timed;
  8. the slab route's main path: a BSM the JAX decision sends to the slab
     plan (n = 8192, 4000 aligned 64x128 f32 blocks and one block whose rows
     run at stride 4, which the panel planner refuses): A @ x and axpby
     through B8 against the float64 bucket route, timed;
  9. the batched products (bench.py's batches: one structure, values from
     seeds 100+i / 200+i / 300+i): ``batched_mm`` on the config-4 recipe
     (config-1 structure, n = 4096, P = 4, r = 128) and on the config-3
     recipe (n = 4096, P = 4), one B4 launch each, and its gradient (one
     prologue and one B2 transposed launch for the P products); at the
     real size (phase 3's recipe, P = 4, r = 128) timed beside the loop of
     four B2 launches, B4 at precision=None beside it, and the dX of the
     batch (B2's transpose at P = 4) at both tiers;
     ``batched_mv`` on the config-2 (fused mirror plan)
     and config-3 recipes at n = 4096, P = 16, one B6 launch each, timed
     beside the loop of 16 B5 launches, and its gradient; above the
     24 MB/product cap (config 3 at n = 32768, P = 4) the batch loops (four
     B5 launches) and B6 is driven directly on the stacked plan, timed;
 10. the r = 1 patch route (kernel B7) on phase 3's, phase 5's and phase
     7's operands built with ``patch="always"``: the bytes B7 reads (its
     live row tiles) and its launch geometry, one B7 launch per product
     (A^T too on config 1, whose plan has G = 1) and no B1/B5/B8, against
     the float64 bucket route, B7 at r = 1 against B2 / B3 on the same
     plan, timed eager and from a CUDA graph beside B5 on the default
     operator, B7's plain version and the library call, and A^T x on
     config 1 (mode t) timed the same way;
 11. the panel v2 route (kernel B10) on the same operands built with
     ``panel="v2"``: each plan's seg, bytes, host seconds and B10's launch
     geometry, one B10 launch per product (a mirror launch on the
     symmetric operand's fused plan) and no B5, against the float64 bucket
     route, B10 against its plain version at one tile per block, the whole
     stream in one block and its own geometry, timed as in phase 10; a
     ``batched_mv`` of two v2 operators loops (no B6);
 12. the BEM solve: ``examples/bem_solve.py``'s recipe at n = 8192 (128
     z-slice clusters of 64 points, thresh 0.6, f32) as a
     ``SymmetricBlockMatrix`` on the card, with the example's self-term
     64; an independent dense float64 assembly of the recipe (not through
     the port) is the oracle: its extreme eigenvalues (``eigvalsh`` on the
     card; the system must be positive definite) and scipy's plain CG on
     it; ``cg`` plain and with ``M = block_jacobi(S)``, ``bicgstab`` and
     ``gmres`` with M, at tol 1e-5, each converged with a float64 residual
     on that assembly <= 2 tol |b| (GMRES, which converges on the
     preconditioned residual: |M (b - A x)| <= 2 tol |M b|, M the inverses
     of its diagonal blocks), its exact launches (one S and one M product
     per CG step, the chunk's frozen steps included) and host reads
     (``solvers.HOST_CHECKS``); the port's float64 operator against the
     assembly, and its block-Jacobi CG at tol 1e-10 against
     ``scipy.sparse.linalg.cg`` on the assembly with its block inverses
     (iterations within one, x within 1e-8); the host syncs of one and two
     chunks of each solver under ``torch.cuda.set_sync_debug_mode("warn")``
     by source line (the solver's only at its reads); eager ms per
     iteration of each solver beside its products replayed from a CUDA
     graph (and a whole CG / BiCGStab chunk replayed, held to an eager
     chunk within 1e-5), and the set-up
     seconds (``--solve`` runs this phase alone);
 13. the complex Helmholtz BEM (``--complex`` runs this phase alone): phase
     12's geometry with exp(i k r) / (4 pi r) blocks, k = 16, self-term 64,
     as a complex64 ``SymmetricBlockMatrix`` (128 + 4123 blocks of 64 x 64,
     139.3 MB); ``S @ x``, ``S.T @ x``, ``S.H @ x``, ``S.conj() @ x`` and
     ``S @ X`` (r = 64) against an independent dense complex128 assembly of
     the recipe (rounded through complex64, as the values are), each with
     exactly 2 B1 launches (one symmetric) and nothing else, and ``S @ X``
     at r = 16 too (r > 1: both launches on the complex64 tensor-core
     instance, counted under "B1 mma"); the same recipe
     on scattered index lists (schedule "serial"): 2 B9 element passes per
     product; ``S @ x`` and ``S @ X`` (r = 16 and 64) timed eager and from
     a CUDA graph beside their bound, a complex64 CSR call of torch.sparse,
     the same products through ``split_complex(S)`` (four f32 products on
     the real routes) and, at r > 1, B1's FMA instance on the same tables;
     both complex64 instances of B1 at r in {2, 4, 8, 16, 32, 64} (graph
     ms, where the tensor cores take over beside the least r of
     ``fused_spmm.MMA_RULES``); GMRES(20) + ``block_jacobi`` in complex64 at tol 1e-5 (held
     to its preconditioned residual on the assembly, exact launches and
     host reads, its iterations within 3 of scipy's GMRES(20) with the same
     block inverses), complex128 GMRES at tol 1e-12 against scipy's
     solution within 1e-10, the complex128 operator's ``S @ X`` at r = 16
     and 64 (B1's complex128 tensor-core instance: exact launches by entry
     point, within 1e-12 of the complex128 assembly) timed eager and from
     a CUDA graph beside the FMA instance on the same tables, a complex128
     CSR call and the bound, both complex128 instances scanned over r, and
     eager ms per GMRES iteration beside its products' CUDA-graph floor;
 14. options, dtype rules and interop (``--options`` runs this phase
     alone): phase 12's BEM operator stored bf16 (``dtype=torch.bfloat16``)
     with f32 and f64 operands, contiguous (B1's bf16 -> f32 / f64
     instances) and on scattered index lists (B9's element pass), against
     the f32 operator within 2e-2 and against its own bf16 values in
     float64 within 1e-5 (f32 results) or 1e-12 (f64), ``S @ X`` (r = 64)
     on B1's bf16 -> f32 tensor-core instance timed beside the FMA
     instance on the same tables, the f32 operator's B3 and the CSR call,
     both bf16 instances scanned over r; an f64 operand on
     the flagship and on its scattered copy (f32 -> f64 instances, f64
     results within 1e-12 of float64 scipy, no B2 or B5), a complex128
     operand on phase 13's complex64 BEM, both numberings (c64 -> c128,
     ``S.H`` included); every new instance against its plain version on
     the card, with exact launches by entry point; ``scatter="sorted"``
     on the scattered flagship (B9's owner mode: three products
     ``torch.equal`` per kind at r = 1, 64 and 128, within f32 tolerance of
     the atomic element pass and float64 scipy, timed beside it and beside
     a float32 CSR call at r = 1 and 64, each of its two passes alone at
     r = 64), the same on config 1 renumbered (n = 8192, 2000 x 128^2 f32,
     256,000 contributions: its bucket route in the owner mode at r = 1
     and 128, two products bit-equal, timed beside the atomic pass, the
     CSR call and the bound), phase 12's BEM operator with an f64 operand
     (B1 f32 -> f64) and its scattered copy's element pass in f32 and f32
     -> f64, each beside the CSR call of its compute type, and every
     other owner instance on that
     flagship stored f64, bf16, complex64 and complex128 (A @, A.T @ and
     for complex A.H @ and A.conj() @ with each operand dtype that
     reaches it: against its plain version, exact launches by entry point
     (at r = 64 the two passes), two products bit-equal, against a dense
     float64 / complex128 copy of its values), bf16 ``S @ X``'s values in
     an f32 CSR ``@ X``; config 1 stored float64, ``A @ X`` and ``A.T @
     X`` at r = 128 on B1's float64 tensor-core instance against float64
     scipy (1e-12), exact launches by entry point, timed beside the FMA
     instance, a float64 CSR call and the bound, both float64 instances
     scanned over r (to 128); save / load of the BEM operator (f32 and
     bf16) through a temporary directory onto the card, staged tensors
     ``torch.equal`` and load seconds; ``to_bcoo`` on the card against
     ``to_scipy``; ``schedule="auto"`` with the colored operator's
     launches;
 15. the distributed layer (``--distributed`` runs this phase alone):
     block-row shards of one operator on this card (``parallel/``), each
     shard's groups through B1 and B9's element pass: phase 12's BEM on 4
     shards (``D @ x``, ``D.T @ x``, ``D @ X`` r = 64, ``cg`` through D
     within one iteration of the single operator's and x within 1e-5 of
     its solution, the float64 operator's ``D @ x`` against scipy at
     1e-12), the same BEM on scattered lists (element groups: B9), phase
     3's config 1 on 4 shards (``D @ x``, ``D.T @ x``, ``D @ X`` r = 128,
     and a 4 x 2 rows x rhs mesh at r = 6: one ring per column group) and
     phase 7's config 3 on 8 shards; each product against the single
     operator and the float64 plain route at 1e-5, with exact launches (one
     B1 per non-empty chunked table and one element pass per non-empty
     element table of each shard, nothing else); per operand the halo
     bytes, construction seconds, and ``D @ x`` eager and from a CUDA graph
     beside the single operator's default route and its bound.  The
     cross-device and NCCL transports run only where the process sees two
     cards or more (``--mesh`` runs them alone: the BEM's shards on every
     card of one process, then one process per card over NCCL,
     ``--nccl-worker`` being that check's worker); otherwise the phase
     says why they did not;
 16. the route autotuner (``--autotune`` runs this phase alone;
     ``utils/autotune.py``): ``autotune_backend`` on config 1 (n = 8192)
     and the symmetric real size (n = 32768) at r = 1 and r = 128 and on
     the VBCRS real size (n = 32768) at r = 1 -- every route open to the
     operator (bucket, panel, slab, patch) timed by the chained timer and
     from a CUDA graph, printed beside the route the v5e rules pick and the
     winner -- then one product launching exactly the winner's kernels,
     within 1e-5 of the float64 plain route, and a save / load of each
     operator (the policy table emptied, as in a new process) whose
     products launch the saved winners' kernels; ``autotune_optimize`` on
     config 1 at r = 128 (G, steps and padding slots of both plans, B2
     under each) and the product under the winning bias; the seconds the
     tuning takes.

Phases 3, 5, 7, 12, 13 and 14 also put the two r = 1 bodies of B1 and
B9's element pass (the row-stream body and the tile core) side by side on
the operands they time ("r = 1 bodies" lines: graph and eager ms, the zero
fill of y and the launches alone), and phase 14 scans both bodies on the
BEM stored in every dtype (B1 contiguous, B9 scattered), the measurement
behind ``fused_spmm.R1_RULES``.

Every timed kernel also gets its bound -- the larger of its logical bytes
(stored values, operands and results, each once) over 3.35 TB/s and its
operations over the peak rate of the tier's arithmetic: 495 / 3 = 165
TFLOP/s (3xTF32, the fastest tensor-core way to fp32 accuracy) for
"highest" and "high" (complex64 included), 495 TFLOP/s (TF32) for
precision=None, 67 TFLOP/s (FP64 tensor cores) for a float64 or
complex128 compute type, 989 / 3 TFLOP/s (three bf16 passes) for bf16
values times a float32 operand; 8 operations per complex multiply-add
(``product_bound``) -- and the time of one PyTorch call that computes the same function (a CSR product
through torch.sparse, or index_select / index_add_), which the port never
calls, eager and replayed from a CUDA graph where the call captures.

Tolerances: |kernel - reference| <= tol * max(1, max|reference|) with tol
1e-5 for f32 and complex64 (3xTF32 included) and 1e-12 for f64 and
complex128; the kernels add into
their outputs with atomics (run-to-run summation order), so bit equality
is not expected.  B2, B3 and B4 at precision=None run one TF32 pass: each
operand keeps 11 significant bits (unit roundoff 2^-11 = 4.9e-4), so each
product is off by up to ~1e-3 of itself, and a sum of K ~ 1000
random-sign products drifts by ~sqrt(K) 1e-3 of a typical product while
max|reference| is ~4 sqrt(K) of one: TOL_TF32 = 2e-3 holds that with
margin for K <= 1024.  Any failure raises and exits nonzero.  The
second-to-last line is a JSON summary of the kernels, the last line a JSON
device record; before them, one line per kernel puts its timed product's
graph time beside its bound and its library call.

Needs one CUDA card, nvcc, torch and scipy; imports no jax.
"""

from __future__ import annotations

import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter

import numpy as np
import scipy.sparse.linalg as spla
from scipy.sparse import block_diag
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")

import blocksparse_tpu_torch as bt  # noqa: E402
from blocksparse_tpu_torch import solvers  # noqa: E402
from blocksparse_tpu_torch.core.layout import build_layout  # noqa: E402
from blocksparse_tpu_torch.core import panel2  # noqa: E402
from blocksparse_tpu_torch.core.panel import (  # noqa: E402
    PanelPlan, _best_shift_variant, _layout_entries, build_panel_plan,
    panel_plan_from_layout)
from blocksparse_tpu_torch.core.patch import CC, build_patch_plan  # noqa: E402
from blocksparse_tpu_torch.core.strip import (  # noqa: E402
    plan_from_layout, plan_symmetric)
from blocksparse_tpu_torch.core import panel as core_panel  # noqa: E402
from blocksparse_tpu_torch.formats import symmetric as symmetric_format  # noqa: E402
from blocksparse_tpu_torch.formats import vbcrs as vbcrs_format  # noqa: E402
from blocksparse_tpu_torch.ops import (  # noqa: E402
    batched, dispatch, panel_router, patch_engine)
from blocksparse_tpu_torch.ops.dispatch import (  # noqa: E402
    apply_operand, apply_symmetric, bucket_tables, element_plan,
    patch_eligible, patch_wins)
from blocksparse_tpu_torch.ops.kernels import (  # noqa: E402
    batched_spmm, fused_spmm, mask_select, panel2_spmv, panel_spmv,
    patch_spmv1, slab_spmv)
from blocksparse_tpu_torch.ops.kernels.fused_spmm import (  # noqa: E402
    BucketTable)
from blocksparse_tpu_torch.ops.torch_spmv import bucket_apply  # noqa: E402
from blocksparse_tpu_torch.parallel import multihost  # noqa: E402
from blocksparse_tpu_torch.parallel.distributed import distribute  # noqa: E402
from blocksparse_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from blocksparse_tpu_torch.utils import autotune, build  # noqa: E402
from blocksparse_tpu_torch.utils.testmatrices import (  # noqa: E402
    random_block_sparse, random_symmetric)

DEV = torch.device("cuda", 0)
ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.complex64: 1e-5,
       torch.complex128: 1e-12}
TOL32 = TOL[torch.float32]
TOL_TF32 = 2e-3  # one TF32 pass (precision=None); see the module docstring
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TF32_FLOPS_PER_S = 495e12  # H100 SXM data sheet, dense TF32 tensor cores
# operations per second at each precision tier: 3xTF32 (three TF32
# products per product) reaches fp32 accuracy; None is one TF32 pass
FP64_FLOPS_PER_S = 67e12  # H100 SXM data sheet, FP64 tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
PEAK_FLOPS = {"highest": TF32_FLOPS_PER_S / 3, "high": TF32_FLOPS_PER_S / 3,
              None: TF32_FLOPS_PER_S,
              # float64 / complex128 compute: the FP64 tensor cores
              "float64": FP64_FLOPS_PER_S,
              # bf16 values times a float32 operand at fp32 accuracy: the
              # values are exact in bf16 and the operand splits exactly into
              # three bf16 parts (8 + 8 + 8 significant bits), so three bf16
              # passes with float32 sums reach it
              "bf16 x f32": BF16_FLOPS_PER_S / 3}
TIER_TOL = {"highest": TOL32, None: TOL_TF32}
B1_SRC = "blocksparse_tpu_torch/csrc/fused_spmm.cu"
B1_MMA_SRC = "blocksparse_tpu_torch/csrc/complex_mma.cu"
B1_DMMA_SRC = "blocksparse_tpu_torch/csrc/dmma.cu"
B1_BF16_MMA_SRC = "blocksparse_tpu_torch/csrc/bf16_mma.cu"
B9_OWNER_SRC = "blocksparse_tpu_torch/csrc/owner_pass.cu"
B9_ROUNDS_SRC = "blocksparse_tpu_torch/csrc/colored_rounds.cu"
B9_COLORED_REPLACES = "blocksparse_tpu/ops/xla_spmv.py:159"
ROWS_SRC = "blocksparse_tpu_torch/csrc/row_stream.cuh"
B2_SRC = "blocksparse_tpu_torch/csrc/patch_spmm.cu"
B1_REPLACES = "blocksparse_tpu/ops/pallas/fused_spmm.py:81"
B2_REPLACES = "blocksparse_tpu/ops/patch_engine.py:329"
B2_TR_REPLACES = "blocksparse_tpu/ops/patch_engine.py:371"
B2_TR_SRC = "blocksparse_tpu_torch/csrc/patch_spmm_tr.cu"
B3_SRC = "blocksparse_tpu_torch/csrc/patch_sym.cu"
B3_REPLACES = "blocksparse_tpu/ops/patch_engine.py:345"
B9_SRC = "blocksparse_tpu_torch/csrc/mask_select.cu"
B9_GATHER_REPLACES = "blocksparse_tpu/ops/pallas/mask_select.py:70"
B9_SCATTER_REPLACES = "blocksparse_tpu/ops/pallas/mask_select.py:82"
B5_SRC = "blocksparse_tpu_torch/csrc/panel_spmv.cu"
B5_REPLACES = "blocksparse_tpu/ops/pallas/panel_spmv.py:85"
B8_SRC = "blocksparse_tpu_torch/csrc/slab_spmv.cu"
B8_REPLACES = "blocksparse_tpu/ops/pallas/slab_spmv.py:85"
B4_SRC = "blocksparse_tpu_torch/csrc/batched_spmm.cu"
B4_REPLACES = "blocksparse_tpu/ops/batched.py:46"
B6_REPLACES = "blocksparse_tpu/ops/pallas/panel_spmv.py:305"
B7_SRC = "blocksparse_tpu_torch/csrc/patch_spmv1.cu"
B7_REPLACES = "blocksparse_tpu/ops/patch_engine.py:175"
B10_SRC = "blocksparse_tpu_torch/csrc/panel2_spmv.cu"
B10_REPLACES = "blocksparse_tpu/ops/pallas/panel2_spmv.py:90"
STREAM_KERNEL = {"panel": "B5", "strip": "B8", None: "B1"}
MODE_KW = {"forward": {}, "transpose": {"transpose": True},
           "symmetric": {"symmetric": True}}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def abs_err(name: str, got: torch.Tensor, ref, tol: float) -> tuple:
    """(max |got - ref|, tol * max(1, max|ref|)); raises past the limit."""
    ref = torch.as_tensor(np.asarray(ref)) if not isinstance(ref, torch.Tensor) else ref
    got64, ref64 = (t.detach().resolve_conj().to(
        torch.complex128 if t.is_complex() else torch.float64).cpu()
        for t in (got, ref))
    require(tuple(got64.shape) == tuple(ref64.shape),
            f"{name}: shape {tuple(got64.shape)} != {tuple(ref64.shape)}")
    require(bool(torch.isfinite(got64).all()), f"{name}: non-finite output")
    err = float((got64 - ref64).abs().max()) if got64.numel() else 0.0
    scale = max(1.0, float(ref64.abs().max()) if ref64.numel() else 1.0)
    require(err <= tol * scale, f"{name}: error {err:.3e} above {tol * scale:.3e}")
    return err, tol * scale


def rel_check(name: str, got: torch.Tensor, ref, tol: float) -> float:
    """Max |got - ref| against tol * max(1, max|ref|); returns the abs error."""
    err, limit = abs_err(name, got, ref, tol)
    print(f"  {name}: max_abs_err {err:.3e}  limit {limit:.3e} (tol {tol:g})")
    return err


def batch_check(name: str, out: torch.Tensor, refs, tol: float = TOL32) -> float:
    """Each product of a batch against its reference (rel_check's rule per
    product), in one line; returns the largest abs error."""
    require(out.shape[0] == len(refs), f"{name}: {out.shape[0]} products, "
            f"{len(refs)} references")
    got = [abs_err(f"{name} [{p}]", out[p], ref, tol)
           for p, ref in enumerate(refs)]
    err = max(e for e, _ in got)
    print(f"  {name}: {len(refs)} products, max_abs_err {err:.3e}, smallest "
          f"limit {min(lim for _, lim in got):.3e} (tol {tol:g})")
    return err


def bound(nbytes: float, flops: float, precision="highest") -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of nbytes over 3.35 TB/s and flops over the tier's peak
    (``PEAK_FLOPS``)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[precision] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def product_bound(op, r: int = 1, compute=None) -> tuple:
    """``bound`` of ``op @ X`` ([n, r] of ``compute``, by default the
    operator's dtype): the stored values once in their own type, X and the
    result once in ``compute``; 2 operations per multiply-add (8 complex)
    on every logical entry (a symmetric off-diagonal twice) at the peak of
    the fastest way to the compute type's accuracy (``PEAK_FLOPS``: the
    FP64 tensor cores for float64 / complex128, three bf16 passes for bf16
    values with a float32 operand, else the operator's tier)."""
    compute = compute or op.dtype
    entries = (op._dlayout.nnz + 2 * op._olayout.nnz
               if hasattr(op, "_dlayout") else op.nnz)
    stored = torch.empty(0, dtype=op.dtype).element_size()
    isz = torch.empty(0, dtype=compute).element_size()
    nbytes = logical_nnz(op) * stored + sum(op.shape) * r * isz
    flops = (8.0 if compute.is_complex else 2.0) * entries * r
    if compute in (torch.float64, torch.complex128):
        tier = "float64"
    elif op.dtype == torch.bfloat16:
        tier = "bf16 x f32"
    else:
        tier = op.precision
    return bound(nbytes, flops, tier)


def csr_on_card(ops, transpose=False) -> torch.Tensor:
    """The operators (symmetric ones expanded; transposed with
    ``transpose``) block-diagonally in one f32 CSR tensor on the card,
    duplicates summed: the operand of the library call that the kernels
    are timed beside."""
    rows, cols, vals = [], [], []
    r0 = c0 = 0
    for op in ops:
        r, c, v = bt.rowcolvals(op)
        if transpose:
            r, c = c, r
        rows.append(torch.from_numpy(r).to(DEV) + r0)
        cols.append(torch.from_numpy(c).to(DEV) + c0)
        vals.append(torch.from_numpy(np.asarray(v, np.float32)).to(DEV))
        m, n = op.shape[::-1] if transpose else op.shape
        r0, c0 = r0 + m, c0 + n
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (r0, c0)).coalesce()
    return coo.to_sparse_csr()


class LibraryTime(float):
    """A library call's eager median (the float), with ``graph``: its
    median replay from a CUDA graph (device time), or None where the call
    does not capture."""

    graph: float | None = None


def library_ms(label: str, call, kernel_out: torch.Tensor,
               card: str) -> LibraryTime:
    """Median CUDA-event time of one PyTorch call computing what a kernel
    computes, its result held against the kernel's: eager, and replayed
    from a CUDA graph where the call captures (cuSPARSE may refuse)."""
    rel_check(f"{label}: library call vs kernel", call(), kernel_out, TOL32)
    ms = LibraryTime(median_ms(call))
    try:
        ms.graph = graph_ms(call)
        note = f"CUDA-graph replay {ms.graph:.4f} ms"
    except (RuntimeError, SmokeFailure) as e:
        torch.cuda.synchronize()
        note = f"does not capture in a CUDA graph ({str(e).splitlines()[0][:120]})"
    print(f"  {label}: library call {ms:.4f} ms eager, {note} [{card}]")
    return ms


def logical_nnz(op) -> int:
    """Stored values of a format (a symmetric off-diagonal once)."""
    if hasattr(op, "_dlayout"):
        return op._dlayout.nnz + op._olayout.nnz
    return op.nnz


def reset_counts() -> None:
    fused_spmm.LAUNCHES = 0
    fused_spmm.SYM_LAUNCHES = 0
    fused_spmm.MMA_LAUNCHES = 0
    fused_spmm.ROW_LAUNCHES = 0
    mask_select.ELEMENT_ROW_LAUNCHES = 0
    patch_engine.LAUNCHES = 0
    patch_engine.TR_LAUNCHES = 0
    patch_engine.XT_LAUNCHES = 0
    patch_engine.SYM_LAUNCHES = 0
    mask_select.GATHER_LAUNCHES = 0
    mask_select.SCATTER_LAUNCHES = 0
    mask_select.ELEMENT_LAUNCHES = 0
    mask_select.ELEMENT_SYM_LAUNCHES = 0
    mask_select.OWNER_LAUNCHES = 0
    mask_select.COLORED_LAUNCHES = 0
    mask_select.ROUNDS_LAUNCHES = 0
    fused_spmm.ENTRY_LAUNCHES.clear()
    for mod in (panel_spmv, slab_spmv):
        mod.LAUNCHES = 0
        mod.MIRROR_LAUNCHES = 0
    batched_spmm.LAUNCHES = 0
    panel_spmv.BATCHED_LAUNCHES = 0
    panel_spmv.BATCHED_MIRROR_LAUNCHES = 0
    patch_spmv1.LAUNCHES = 0
    panel2_spmv.LAUNCHES = 0
    panel2_spmv.MIRROR_LAUNCHES = 0


def counts() -> dict:
    """Kernel launches since the last reset ("B1 sym": those of B1 in its
    symmetric mode, also counted under "B1"; "B1 mma": those of its
    tensor-core instances (``fused_spmm.MMA_RULES``), also under "B1"; "B9 element": B9's element
    passes, "B9 element sym" those in the symmetric mode, "B9 owner" its
    owner mode (scatter="sorted"), "B9 colored" the colored element route's
    products launches and "B9 rounds" its rounds launches (the colored
    rounds, ``csrc/colored_rounds.cu``); "B9 gather" / "B9 scatter" the
    one-call kernels; "B2": B2's
    forward, "B2 transpose" its transposed product, "B2 prologue" its X^T
    launches, one per launch of either; "B5 mirror", "B6 mirror",
    "B8 mirror" and "B10 mirror" those on a mirror plan)."""
    return {"B1": fused_spmm.LAUNCHES, "B1 sym": fused_spmm.SYM_LAUNCHES,
            "B1 mma": fused_spmm.MMA_LAUNCHES,
            "B2": patch_engine.LAUNCHES,
            "B2 transpose": patch_engine.TR_LAUNCHES,
            "B2 prologue": patch_engine.XT_LAUNCHES,
            "B3": patch_engine.SYM_LAUNCHES,
            "B9 gather": mask_select.GATHER_LAUNCHES,
            "B9 scatter": mask_select.SCATTER_LAUNCHES,
            "B9 element": mask_select.ELEMENT_LAUNCHES,
            "B9 element sym": mask_select.ELEMENT_SYM_LAUNCHES,
            "B9 owner": mask_select.OWNER_LAUNCHES,
            "B9 colored": mask_select.COLORED_LAUNCHES,
            "B9 rounds": mask_select.ROUNDS_LAUNCHES,
            "B5": panel_spmv.LAUNCHES,
            "B5 mirror": panel_spmv.MIRROR_LAUNCHES,
            "B8": slab_spmv.LAUNCHES, "B8 mirror": slab_spmv.MIRROR_LAUNCHES,
            "B4": batched_spmm.LAUNCHES, "B6": panel_spmv.BATCHED_LAUNCHES,
            "B6 mirror": panel_spmv.BATCHED_MIRROR_LAUNCHES,
            "B7": patch_spmv1.LAUNCHES, "B10": panel2_spmv.LAUNCHES,
            "B10 mirror": panel2_spmv.MIRROR_LAUNCHES}


def grown_since(before: dict) -> dict:
    now = counts()
    return {k: now[k] - before[k] for k in now}


def stream_kernel(op, transpose=False) -> str:
    """The kernel an f32 r = 1 product of ``op`` runs on its stream route:
    B5 (B10 on a v2 panel plan), B8 or B1 (the bucket route)."""
    choice, plan, _ = op._stream_entry(transpose)
    if choice == "panel" and isinstance(plan, panel2.Panel2Plan):
        return "B10"
    return STREAM_KERNEL[choice]


def stream_want(op, transpose=False, k=1) -> dict:
    """Exact launches of k f32 r = 1 products through the stream route."""
    plan = op._stream_entry(transpose)[1]
    name = stream_kernel(op, transpose)
    want = {"B1": 0, "B1 sym": 0, "B9 gather": 0, "B9 scatter": 0,
            "B9 element": 0, "B9 colored": 0, "B9 rounds": 0, "B7": 0}
    for kern in ("B5", "B8", "B10"):
        want[kern] = k * (name == kern)
        want[f"{kern} mirror"] = k * (name == kern and plan.mirror)
    return want


def plain_stream(op, x, transpose=False):
    """The stream route's plain version, or None where ``op`` takes the
    bucket route."""
    choice, plan, dev = op._stream_entry(transpose)
    if choice == "panel" and isinstance(plan, panel2.Panel2Plan):
        return panel2_spmv.panel2_apply_plain(plan, dev, x)
    if choice == "panel":
        return panel_spmv.panel_apply_plain(plan, dev, x)
    if choice == "strip":
        return slab_spmv.slab_apply_plain(plan, dev, x)
    return None


def bucket_route(A, x, transpose=False):
    """A BSM's or VBCRS's bucket route, driven explicitly (one B1 launch
    over the chunked buckets, one B9 element pass over the element
    buckets)."""
    out_len = A.shape[1] if transpose else A.shape[0]
    colors = None
    if isinstance(A, bt.BlockSparseMatrix) and not bt.isserial(A.schedule):
        colors = A.transposecolors() if transpose else A.colors()
    return apply_operand(A._buckets, A.layout, out_len, x,
                         transpose=transpose, colors=colors)


def bucket_route_sym(S, x, transpose=False):
    """S's bucket route, driven explicitly (per layout one B1 launch and
    one B9 element pass, the off-diagonal's in their symmetric modes)."""
    colored = not bt.isserial(S.schedule)
    return apply_symmetric(
        S._dbuckets, S._dlayout, S._obuckets, S._olayout, S.shape[0], x,
        transpose=transpose,
        diag_colors=S.diagonalcolors() if colored else None,
        fused_colors=S.fusedcolors() if colored else None)


def plain_buckets(layout, buckets, x, out_len, dtype, *, transpose=False,
                  symmetric=False) -> torch.Tensor:
    """Bucketed operand through the plain versions only (serial scatter)."""
    y = x.new_zeros((out_len,) + tuple(x.shape[1:]))
    elem = []
    for hb, (v, ri, ci, rc, cc) in zip(layout.buckets, buckets):
        if hb.chunk > 1:
            y = y + fused_spmm.chunked_block_apply_plain(
                v.to(dtype), rc, cc, hb.chunk, x, out_len,
                transpose=transpose, symmetric=symmetric)
        else:
            elem.append((v.to(dtype), ri, ci))
    if elem:
        y = y + bucket_apply(elem, out_len, x, transpose=transpose,
                             symmetric=symmetric)
    return y


def plain_patch(op, entry, layouts_reads, x, dtype, transpose=False):
    """The patch route's plain version when ``op`` would take it (the
    caller has checked ``patch_eligible``)."""
    r = 1 if x.ndim == 1 else x.shape[1]
    if entry is None or not patch_wins(entry[0], layouts_reads, r, op.patch):
        return None
    plan, dev = entry
    dev = [patch_engine.BucketArrays((b[0].to(dtype), *b[1:]), b.owners)
           for b in dev]
    if x.ndim == 1:
        return patch_engine.patch_spmv_plain(plan, dev, x,
                                             transpose=transpose)
    return patch_engine.patch_spmm_plain(plan, dev, x, transpose=transpose)


def plain_route(A, x: torch.Tensor, *, transpose=False,
                dtype=None) -> torch.Tensor:
    """A's (BSM or VBCRS) main-path route with every kernel replaced by its
    plain version, optionally in another dtype (the float64 reference on
    the card)."""
    dtype = dtype or A.dtype
    x = x.to(dtype)
    r = 1 if x.ndim == 1 else x.shape[1]
    if patch_eligible(x.float(), A.dtype, A.patch):
        y = plain_patch(A, A._patch_for(), [(A.layout, 1)], x, dtype,
                        transpose)
        if y is not None:
            return y
    if r == 1 and A.dtype == torch.float32:
        y = plain_stream(A, x, transpose)
        if y is not None:
            return y
    out_len = A.shape[1] if transpose else A.shape[0]
    return plain_buckets(A.layout, A._buckets, x, out_len, dtype,
                         transpose=transpose)


def plain_route_sym(S: bt.SymmetricBlockMatrix, x: torch.Tensor, *,
                    transpose=False, dtype=None) -> torch.Tensor:
    """S's main-path route with every kernel replaced by its plain version."""
    dtype = dtype or S.dtype
    x = x.to(dtype)
    r = 1 if x.ndim == 1 else x.shape[1]
    if patch_eligible(x.float(), S.dtype, S.patch):
        y = plain_patch(S, S._patch_for(transpose),
                        [(S._dlayout, 1), (S._olayout, 2)], x, dtype)
        if y is not None:
            return y
    if r == 1 and S.dtype == torch.float32:
        y = plain_stream(S, x, transpose)
        if y is not None:
            return y
    return plain_buckets_sym(S, x, transpose=transpose, dtype=dtype)


def plain_buckets_sym(S, x, *, transpose=False, dtype=None) -> torch.Tensor:
    """S's bucket route through the plain versions only."""
    dtype = dtype or S.dtype
    x = x.to(dtype)
    n = S.shape[0]
    return (plain_buckets(S._dlayout, S._dbuckets, x, n, dtype,
                          transpose=transpose)
            + plain_buckets(S._olayout, S._obuckets, x, n, dtype,
                            symmetric=True))


def elem_ids(layout) -> list:
    return [i for i, b in enumerate(layout.buckets) if b.chunk == 1]


def passes_of(op, transpose=False) -> list:
    """The bucket route's passes of one product of ``op``: per layout
    (layout, colors, out_len, transpose, symmetric, adjoint colors, in_len),
    the adjoint colors those of the transposed pass (x's cotangent)."""
    n = op.shape[0]
    if hasattr(op, "_dlayout"):
        colored = not bt.isserial(op.schedule)
        dcol = op.diagonalcolors() if colored else None
        fcol = op.fusedcolors() if colored else None
        return [(op._dlayout, dcol, n, transpose, False, dcol, n),
                (op._olayout, fcol, n, False, True, fcol, n)]
    colors = adjoint = None
    if isinstance(op, bt.BlockSparseMatrix) and not bt.isserial(op.schedule):
        colors, adjoint = ((op.transposecolors(), op.colors()) if transpose
                           else (op.colors(), op.transposecolors()))
    m, k = op.shape[::-1] if transpose else op.shape
    return [(op.layout, colors, m, transpose, False, adjoint, k)]


def pass_plan(lay, colors, n, tr, sym):
    """The colored plan a pass's element buckets run, or None."""
    return element_plan(lay, elem_ids(lay), n, colors, DEV, transpose=tr,
                        symmetric=sym)


def colored_passes(op, transpose=False) -> list:
    """Per pass with element buckets: True where they run the colored
    element route (a products pass and B9's colored rounds), False where
    the element pass."""
    return [pass_plan(lay, colors, n, tr, sym) is not None
            for lay, colors, n, tr, sym, _a, _k in passes_of(op, transpose)
            if elem_ids(lay)]


def bucket_want(op, transpose=False, backward=False, r=1) -> dict:
    """Exact launches of one bucket-route product of ``op`` with r columns:
    per layout one B1 launch over its chunked buckets (symmetric mode on
    the off-diagonal pass), and over its element buckets one element pass,
    or, under a colored plan, the colored element route: one products
    launch (at r > 1 two on the symmetric pass) and one rounds launch;
    never B9's one-call gather or scatter-add.  ``backward``: with the product's backward, which
    repeats every B1 launch (in the adjoint mode), every element pass and
    the symmetric pass's colored route, and runs a colored general pass's
    cotangent through the transposed pass's plan where it wins (else one
    element pass)."""
    want = {"B1": 0, "B1 sym": 0, "B9 element": 0, "B9 element sym": 0,
            "B9 colored": 0, "B9 rounds": 0, "B9 gather": 0,
            "B9 scatter": 0}

    def element_work(lay, colors, n, tr, sym):
        if pass_plan(lay, colors, n, tr, sym) is None:
            want["B9 element"] += 1
            want["B9 element sym"] += sym
        else:
            want["B9 colored"] += 2 if sym and r > 1 else 1
            want["B9 rounds"] += 1

    for lay, colors, n, tr, sym, adjoint, k in passes_of(op, transpose):
        steps = [(colors, n, tr)]
        if backward:  # the cotangent's pass: colored only after a colored one
            colored = pass_plan(lay, colors, n, tr, sym) is not None
            steps.append((adjoint if colored else None, k,
                          tr if sym else not tr))
        for colors_, n_, tr_ in steps:
            if n_chunked(lay):
                want["B1"] += 1
                want["B1 sym"] += sym
            if elem_ids(lay):
                element_work(lay, colors_, n_, tr_, sym)
    return want


def per_bucket_element_pass(S, x, mask_gs: bool):
    """S's element off-diagonal buckets one bucket at a time, as the route
    ran them before the element pass: a gather, an einsum and a
    scatter-add each, through B9's one-call kernels (``mask_gs``) or
    through torch indexing ops."""
    ids = elem_ids(S._olayout)
    return bucket_apply([S._obuckets[i][:3] for i in ids], S.shape[0], x,
                        symmetric=True, mask_gs=mask_gs)


def element_csr(table: BucketTable, n: int, symmetric: bool) -> torch.Tensor:
    """The element buckets of ``table`` as one f32 CSR matrix on the card
    (V at (rows, cols), with ``symmetric`` also V^T at (cols, rows);
    sentinel lanes dropped, duplicates summed): the operand of the element
    pass's library call."""
    rows, cols, vals = [], [], []
    for v, ridx, cidx, _c in table.buckets:
        r = ridx.long()[:, :, None].expand(v.shape)
        c = cidx.long()[:, None, :].expand(v.shape)
        keep = (r < n) & (c < n)
        pairs = [(r, c)] + ([(c, r)] if symmetric else [])
        for a, b in pairs:
            rows.append(a[keep])
            cols.append(b[keep])
            vals.append(v.float()[keep])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n)).coalesce()
    return coo.to_sparse_csr()


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def replayed(fn) -> tuple:
    """``fn`` captured once in a CUDA graph (after three eager calls on a
    side stream) and replayed once: ``(graph, gap, dtype)``, the gap
    between the replayed output and the last eager one relative to
    max(1, max|eager|)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            ref = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    return graph, float((out - ref).abs().max()) / scale, ref.dtype


def graph_ms(fn) -> float:
    """Device time per call without host launch overhead: the median
    CUDA-event time of ``fn``'s replays from a CUDA graph, whose output is
    held to an eager call within ``TOL`` of its dtype."""
    graph, gap, dtype = replayed(fn)
    require(gap <= TOL[dtype], f"CUDA-graph replay disagrees with the eager "
            f"product: {gap:.3e} > {TOL[dtype]:.0e}")
    return median_ms(graph.replay)


def time_routes(label, kern, plain, nbytes, flops, card):
    """Median CUDA-event times of a kernel route and its plain route, eager
    (plain, kernel, kernel, plain) and replayed from a CUDA graph."""
    p1, k1, k2, p2 = (median_ms(plain), median_ms(kern), median_ms(kern),
                      median_ms(plain))
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    k_dev, p_dev = graph_ms(kern), graph_ms(plain)
    print(f"  {label}: kernel route {k1:.4f} / {k2:.4f} ms, plain route "
          f"{p1:.4f} / {p2:.4f} ms (median of 25 CUDA-event repeats); "
          f"kernel {nbytes / (k_ms * 1e-3) / 1e9:.1f} GB/s "
          f"= {100 * nbytes / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1f}% of "
          f"3.35 TB/s, {flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s [{card}]")
    print(f"  {label}: CUDA-graph replay (no host launch overhead) kernel "
          f"route {k_dev:.4f} ms = {nbytes / (k_dev * 1e-3) / 1e9:.1f} "
          f"GB/s = {100 * nbytes / (k_dev * 1e-3) / HBM_BYTES_PER_S:.1f}% "
          f"of 3.35 TB/s, {flops / (k_dev * 1e-3) / 1e12:.2f} TFLOP/s; "
          f"plain route {p_dev:.4f} ms; device idle share of the eager "
          f"kernel route {max(0.0, 1 - k_dev / k_ms):.2f} [{card}]")
    return k_ms, p_ms, k_dev, p_dev


def contiguous_operator(n, nblocks, bs, seed, value_seed, device,
                        transposed=False, **opts):
    """nblocks uniform bs x bs f32 blocks at distinct block-aligned positions
    (``opts``: the route options of the constructor); with ``transposed``
    the transpose of that operator, built from the transposed blocks."""
    rng = np.random.default_rng(seed)
    ntiles = n // bs
    pos = rng.choice(ntiles * ntiles, size=nblocks, replace=False)
    rows = (pos // ntiles) * bs
    cols = (pos % ntiles) * bs
    vrng = rng if value_seed is None else np.random.default_rng(value_seed)
    blocks = [vrng.standard_normal((bs, bs)).astype(np.float32)
              for _ in range(nblocks)]
    if transposed:
        blocks, rows, cols = [b.T.copy() for b in blocks], cols, rows
    A = bt.BlockSparseMatrix(blocks, [np.arange(r, r + bs) for r in rows],
                             [np.arange(c, c + bs) for c in cols], (n, n),
                             device=device, **opts)
    return A, vrng


# -- phase 1 -------------------------------------------------------------------

def values_of(np_dtype, rng, shape) -> np.ndarray:
    """Standard normal values of ``shape``; complex ones (a normal real
    and imaginary part) for a complex ``np_dtype``."""
    v = rng.standard_normal(shape)
    if np.issubdtype(np_dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(np_dtype)


def as_dtype(blocks, np_dtype, seed: int = 31) -> list:
    """``blocks`` in ``np_dtype``; a complex dtype also gets an imaginary
    part drawn from ``seed``."""
    if not np.issubdtype(np_dtype, np.complexfloating):
        return [b.astype(np_dtype) for b in blocks]
    rng = np.random.default_rng(seed)
    return [(b + 1j * rng.standard_normal(b.shape)).astype(np_dtype)
            for b in blocks]


def b1_cases(np_dtype):
    """(label, vals, row_chunk, col_chunk, C, n) on the card."""
    blocks, rows, cols, shape = random_block_sparse(
        3, shape=(1536, 1536), nblocks=120, max_block=96, dtype=np.float64,
        contiguous=True)
    lay = build_layout(as_dtype(blocks, np_dtype), rows, cols, shape)
    chunked = [b for b in lay.buckets if b.chunk > 1]
    hb = max(chunked, key=lambda b: b.nblocks * b.mp * b.kp)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    yield (f"contiguous layout bucket nb={hb.nblocks} tile={hb.mp}x{hb.kp} "
           f"C={hb.chunk}", t(hb.values), t(hb.row_chunk_idx),
           t(hb.col_chunk_idx), hb.chunk, shape[0])
    rng = np.random.default_rng(11)
    n, nb, mp, kp, C = 2048, 96, 64, 128, 16
    vals = values_of(np_dtype, rng, (nb, mp, kp))
    rc = rng.integers(0, n // C, (nb, mp // C)).astype(np.int32)
    cc = rng.integers(0, n // C, (nb, kp // C)).astype(np.int32)
    yield (f"chunk-scattered tables nb={nb} tile={mp}x{kp} C={C}", t(vals),
           t(rc), t(cc), C, n)


def b1_table(np_dtype):
    """(table, n): every chunked bucket of ``b1_cases``'s layout (mixed
    chunks, n = 1536) and its chunk-scattered bucket, whose chunk ids reach
    rows up to 2048 + 16 (past n: they read zero and scatter nowhere) and
    repeat across blocks."""
    blocks, rows, cols, shape = random_block_sparse(
        3, shape=(1536, 1536), nblocks=120, max_block=96, dtype=np.float64,
        contiguous=True)
    lay = build_layout(as_dtype(blocks, np_dtype), rows, cols, shape)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    buckets = [(t(b.values), t(b.row_chunk_idx), t(b.col_chunk_idx), b.chunk)
               for b in lay.buckets if b.chunk > 1]
    rng = np.random.default_rng(11)
    nb, mp, kp, C = 96, 64, 128, 16
    buckets.append((t(values_of(np_dtype, rng, (nb, mp, kp))),
                    t(rng.integers(0, 2048 // C + 1, (nb, mp // C)).astype(
                        np.int32)),
                    t(rng.integers(0, 2048 // C + 1, (nb, kp // C)).astype(
                        np.int32)), C))
    return BucketTable(buckets), shape[0]


def b1_multi_vs_plain(gen) -> dict:
    """B1's multi-bucket launch against its plain version and against the
    sum of one-bucket launches (the duality of the two entries), f32 / f64
    x forward, transpose, symmetric x r in {1, 64, 200}, adding into an
    output that already holds a partial sum."""
    errs = {"B1 multi": 0.0, "B1 duality": 0.0}
    for np_dtype, dtype in ((np.float32, torch.float32),
                            (np.float64, torch.float64)):
        table, n = b1_table(np_dtype)
        for r in (1, 64, 200):
            X = torch.randn((n, r), generator=gen, dtype=dtype).to(DEV)
            x = X[:, 0].contiguous() if r == 1 else X
            prior = torch.randn(x.shape, generator=gen, dtype=dtype).to(DEV)
            for mode, kw in MODE_KW.items():
                got = fused_spmm.multi_block_apply(table, x, out=prior.clone(),
                                                   **kw)
                ref = fused_spmm.multi_block_apply_plain(
                    table, x, out=prior.clone(), **kw)
                one = prior.clone()
                for v, rt, ct, c in table.buckets:
                    one += fused_spmm.chunked_block_apply(v, rt, ct, c, x, n,
                                                          **kw)
                torch.cuda.synchronize()
                label = f"B1 multi {dtype} {len(table)} buckets {mode} r={r}"
                errs["B1 multi"] = max(errs["B1 multi"], rel_check(
                    label, got, ref, TOL[dtype]))
                errs["B1 duality"] = max(errs["B1 duality"], rel_check(
                    f"{label} vs {len(table)} one-bucket launches", got, one,
                    TOL[dtype]))
    return errs


def element_table_on_card(np_dtype, n: int) -> BucketTable:
    """Element buckets of an n x n operand shaped like the layouts' (square,
    thin and one-column tiles), rows drawn with repeats within and across
    blocks, sentinel lanes (index n) in both tables."""
    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    buckets = []
    for nb, mp, kp in ((512, 64, 64), (300, 2, 128), (200, 128, 1),
                       (64, 1, 256)):
        ridx = rng.integers(0, n, (nb, mp)).astype(np.int32)
        cidx = rng.integers(0, n, (nb, kp)).astype(np.int32)
        ridx[::3, -1] = n
        cidx[1::4, 0] = n
        buckets.append((t(values_of(np_dtype, rng, (nb, mp, kp))), t(ridx),
                        t(cidx), 1))
    return BucketTable(buckets)


def element_vs_plain(gen) -> dict:
    """B9's element pass against its plain version, f32 / f64 x forward,
    transpose, symmetric x r in {1, 64}, adding into an output that holds a
    partial sum; at f32 r = 1 also against the per-bucket chain through
    B9's one-call gather and scatter-add (the duality of the two)."""
    errs = {"B9 element": 0.0, "B9 element duality": 0.0}
    n = 5000
    for np_dtype, dtype in ((np.float32, torch.float32),
                            (np.float64, torch.float64)):
        table = element_table_on_card(np_dtype, n)
        for r in (1, 64):
            X = torch.randn((n, r), generator=gen, dtype=dtype).to(DEV)
            x = X[:, 0].contiguous() if r == 1 else X
            prior = torch.randn(x.shape, generator=gen, dtype=dtype).to(DEV)
            for mode, kw in MODE_KW.items():
                got = mask_select.element_apply(table, x, out=prior.clone(),
                                                **kw)
                ref = mask_select.element_apply_plain(table, x,
                                                      out=prior.clone(), **kw)
                torch.cuda.synchronize()
                label = (f"B9 element pass {dtype} {len(table)} buckets "
                         f"{mode} r={r}")
                errs["B9 element"] = max(errs["B9 element"], rel_check(
                    label, got, ref, TOL[dtype]))
                if dtype == torch.float32 and r == 1:
                    chain = prior + bucket_apply(
                        [b[:3] for b in table.buckets], n, x, mask_gs=True,
                        **kw)
                    errs["B9 element duality"] = max(
                        errs["B9 element duality"], rel_check(
                            f"{label} vs the per-bucket chain of one-call "
                            f"gathers and scatter-adds", got, chain,
                            TOL[dtype]))
    return errs


COMPUTE_DTYPES = (torch.float32, torch.float64, torch.complex64,
                  torch.complex128)


def random_plan(gen, ncolors: int, out_len: int, total: int):
    """A colored plan's shape with random contents: int32 [ncolors,
    out_len] tables on the card whose entries name scratch rows in [0,
    total) or the sentinel total (about a third), rows 0-9 reached by no
    color."""
    t = torch.randint(0, total + 1, (ncolors, out_len), generator=gen,
                      dtype=torch.int32)
    t[torch.rand((ncolors, out_len), generator=gen) < 0.33] = total
    t[:, :10] = total
    return t.to(DEV).contiguous(), total


def rounds_vs_plain(gen) -> dict:
    """B9's colored rounds against the plain rounds on the same scratch,
    every compute dtype x r in {1, 3, 33, 64} x one and 64 colors, on
    tables with sentinel targets and rows no color reaches, out_len 5000
    and 5003; adding into an output that holds a partial sum; two launches
    bit-equal."""
    errs = {"B9 rounds": 0.0}
    bits = []
    for dtype in COMPUTE_DTYPES:
        for r in (1, 3, 33, 64):
            for ncolors in (1, 64):
                for out_len in (5000, 5003):
                    plan = random_plan(gen, ncolors, out_len, 7001)
                    P = torch.randn((7001, r), generator=gen,
                                    dtype=dtype).to(DEV)
                    prior = torch.randn((out_len, r), generator=gen,
                                        dtype=dtype).to(DEV)
                    ref = mask_select.colored_rounds_plain(
                        plan, P, out=prior.clone())
                    got = mask_select.colored_rounds(plan, P, prior.clone())
                    again = mask_select.colored_rounds(plan, P,
                                                       prior.clone())
                    torch.cuda.synchronize()
                    label = (f"B9 rounds {dtype} r={r} {ncolors} colors "
                             f"out_len={out_len}")
                    require(torch.equal(got, again),
                            f"{label}: two launches differ")
                    bits.append(bool(torch.equal(got, ref)))
                    err, _ = abs_err(label, got, ref, TOL[dtype])
                    errs["B9 rounds"] = max(errs["B9 rounds"], err)
    print(f"  B9 rounds vs the plain rounds: {len(bits)} cases, max_abs_err "
          f"{errs['B9 rounds']:.3e}, bit-equal in {sum(bits)}; two launches "
          f"bit-equal in all")
    return errs


def colored_vs_plain(gen) -> dict:
    """B9's colored route (products pass + rounds) against its plain
    version, every stored / compute pair x forward, transpose, symmetric (x
    conj for complex values) x r in {1, 64} (the one-read products at r =
    1, the owner mode's at 64), on element buckets with
    repeated rows and sentinel lanes (blocks of 64 x 64, 2 x 128, 128 x 1,
    1 x 256), under a random plan of 40 colors; two products bit-equal.
    At r = 1 also on the same values as views one element past a 16-byte
    boundary (``unaligned_table``: the one-read kernel then loads value by
    value)."""
    errs = {"B9 colored": 0.0, "B9 colored one-read": 0.0}
    n = 5000
    for stored, compute in VALUE_PAIRS:
        aligned = element_table_typed(stored, n)
        for r in (1, 64):
            X = torch.randn((n, r), generator=gen, dtype=compute).to(DEV)
            x = X[:, 0].contiguous() if r == 1 else X
            prior = torch.randn(x.shape, generator=gen, dtype=compute).to(DEV)
            tables = {"": aligned}
            if r == 1:
                tables[" unaligned values"] = unaligned_table(aligned)
            for mode, (where, table) in itertools.product(
                    ("forward", "transpose", "symmetric"), tables.items()):
                tr, sym = mode == "transpose", mode == "symmetric"
                total = sum(v.shape[0] * (v.shape[1] + v.shape[2] if sym
                                          else v.shape[2 if tr else 1])
                            for v in table.values)
                plan = random_plan(gen, 40, n, total)
                for conj in ((False, True) if stored.is_complex else (False,)):
                    kw = {**MODE_KW[mode], "conj": conj}
                    ref = mask_select.colored_apply_plain(
                        table, plan, x, out=prior.clone(), **kw)
                    got = mask_select.colored_apply(table, plan, x,
                                                    out=prior.clone(), **kw)
                    again = mask_select.colored_apply(table, plan, x,
                                                      out=prior.clone(), **kw)
                    torch.cuda.synchronize()
                    label = (f"B9 colored {pair_name(stored, compute)} {mode}"
                             f"{' conj' if conj else ''} r={r}{where}")
                    require(torch.equal(got, again),
                            f"{label}: two products differ")
                    err, _ = abs_err(label, got, ref, TOL[compute])
                    key = "B9 colored" + (" one-read" if r == 1 else "")
                    errs[key] = max(errs[key], err)
    print(f"  B9 colored route vs its plain version: every pair, mode and "
          f"conj, max_abs_err r = 1 (one-read products) "
          f"{errs['B9 colored one-read']:.3e}, r = 64 (the owner mode's "
          f"products) {errs['B9 colored']:.3e}, r = 1 also on values one "
          f"element past a 16-byte boundary; two products bit-equal in all")
    return errs


ALL_DTYPES = ["float32", "float64", "complex64", "complex128"]
COMPLEX_DTYPES = ((np.complex64, torch.complex64),
                  (np.complex128, torch.complex128))


def complex_vs_plain(gen) -> dict:
    """B1 (one bucket per launch, and every bucket of a table in one launch
    against its plain version and the sum of one-bucket launches) and B9's
    element pass at complex64 / complex128 x forward, transpose, symmetric
    x conj off / on x r in {1, 64}, against their plain versions on the
    card, adding into an output that holds a partial sum."""
    errs = {"B1 complex": 0.0, "B1 multi complex": 0.0,
            "B1 duality complex": 0.0, "B9 element complex": 0.0}
    n_elem = 5000
    for np_dtype, dtype in COMPLEX_DTYPES:
        cases = list(b1_cases(np_dtype))
        table, n_tab = b1_table(np_dtype)
        etable = element_table_on_card(np_dtype, n_elem)
        for r in (1, 64):
            for mode, kw in MODE_KW.items():
                for conj in (False, True):
                    tag = f"{dtype} {mode}{' conj' if conj else ''} r={r}"
                    for label, vals, rc, cc, C, n in cases:
                        X = torch.randn((n, r), generator=gen, dtype=dtype)
                        x = (X[:, 0] if r == 1 else X).contiguous().to(DEV)
                        got = fused_spmm.chunked_block_apply(
                            vals, rc, cc, C, x, n, conj=conj, **kw)
                        ref = fused_spmm.chunked_block_apply_plain(
                            vals, rc, cc, C, x, n, conj=conj, **kw)
                        torch.cuda.synchronize()
                        errs["B1 complex"] = max(errs["B1 complex"], rel_check(
                            f"B1 {label} {tag}", got, ref, TOL[dtype]))
                    X = torch.randn((n_tab, r), generator=gen, dtype=dtype)
                    x = (X[:, 0] if r == 1 else X).contiguous().to(DEV)
                    prior = torch.randn(x.shape, generator=gen,
                                        dtype=dtype).to(DEV)
                    got = fused_spmm.multi_block_apply(
                        table, x, out=prior.clone(), conj=conj, **kw)
                    ref = fused_spmm.multi_block_apply_plain(
                        table, x, out=prior.clone(), conj=conj, **kw)
                    one = prior.clone()
                    for v, rt, ct, c in table.buckets:
                        one += fused_spmm.chunked_block_apply(
                            v, rt, ct, c, x, n_tab, conj=conj, **kw)
                    torch.cuda.synchronize()
                    label = f"B1 multi {len(table)} buckets {tag}"
                    errs["B1 multi complex"] = max(
                        errs["B1 multi complex"],
                        rel_check(label, got, ref, TOL[dtype]))
                    errs["B1 duality complex"] = max(
                        errs["B1 duality complex"],
                        rel_check(f"{label} vs one-bucket launches", got, one,
                                  TOL[dtype]))
                    X = torch.randn((n_elem, r), generator=gen, dtype=dtype)
                    x = (X[:, 0] if r == 1 else X).contiguous().to(DEV)
                    prior = torch.randn(x.shape, generator=gen,
                                        dtype=dtype).to(DEV)
                    got = mask_select.element_apply(
                        etable, x, out=prior.clone(), conj=conj, **kw)
                    ref = mask_select.element_apply_plain(
                        etable, x, out=prior.clone(), conj=conj, **kw)
                    torch.cuda.synchronize()
                    errs["B9 element complex"] = max(
                        errs["B9 element complex"], rel_check(
                            f"B9 element pass {len(etable)} buckets {tag}",
                            got, ref, TOL[dtype]))
    return errs


# every stored / compute pair of B1 and B9 (fused_spmm.COMPUTE_TYPES)
VALUE_PAIRS = tuple((stored, compute)
                    for stored, computes in fused_spmm.COMPUTE_TYPES.items()
                    for compute in computes)


def element_table_typed(stored: torch.dtype, n: int) -> BucketTable:
    """``element_table_on_card``'s buckets with values stored in
    ``stored`` (bf16: rounded from float32)."""
    np_dt = (np.float32 if stored == torch.bfloat16
             else torch.empty(0, dtype=stored).numpy().dtype)
    table = element_table_on_card(np_dt, n)
    return BucketTable([(v.to(stored).contiguous(), ri, ci, c)
                        for v, ri, ci, c in table.buckets])


def unaligned_table(table: BucketTable) -> BucketTable:
    """``table``'s buckets with each values tensor copied into a view that
    starts one element past a 16-byte boundary (still contiguous)."""
    def shifted(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        return out
    return BucketTable([(shifted(v), ri, ci, c)
                        for v, ri, ci, c in table.buckets])


def owner_vs_plain(gen) -> dict:
    """B9's owner mode (its two passes) against its plain version, every
    stored / compute pair x forward, transpose (x conj for complex values)
    x r in {1, 3, 64, 128}, adding into an output that holds a partial
    sum, on element buckets with repeated rows and sentinel lanes; two
    launches bit-equal."""
    errs = {"B9 owner": 0.0}
    n = 5000
    for stored, compute in VALUE_PAIRS:
        table = element_table_typed(stored, n)
        for r in (1, 3, 64, 128):
            X = torch.randn((n, r), generator=gen, dtype=compute).to(DEV)
            x = X[:, 0].contiguous() if r == 1 else X
            prior = torch.randn(x.shape, generator=gen, dtype=compute).to(DEV)
            for mode in ("forward", "transpose"):
                for conj in ((False, True) if stored.is_complex else (False,)):
                    kw = {**MODE_KW[mode], "conj": conj}
                    got = mask_select.owner_apply(table, x, out=prior.clone(),
                                                  **kw)
                    again = mask_select.owner_apply(table, x,
                                                    out=prior.clone(), **kw)
                    ref = mask_select.owner_apply_plain(table, x,
                                                        out=prior.clone(), **kw)
                    torch.cuda.synchronize()
                    label = (f"B9 owner {pair_name(stored, compute)} {mode}"
                             f"{' conj' if conj else ''} r={r}")
                    require(torch.equal(got, again),
                            f"{label}: two launches differ")
                    errs["B9 owner"] = max(errs["B9 owner"], rel_check(
                        f"{label} vs its plain version", got, ref,
                        TOL[compute]))
    return errs


# (nb, mp, kp, chunk) of the buckets the row-stream body is checked on: 8-row
# chunked tiles, a 64 x 512 and a 64 x 1536 block (two column chunks of
# row_stream.cuh's kColChunk), one block, no block, rows of 27 and of 1
# values (not a multiple of 16 bytes: bf16 rows of odd length), a tile of
# 96 rows (a second item of 32) and single-row blocks; chunk 1 makes them
# element buckets (B9)
ROW_SHAPES = ((40, 8, 128, 8), (3, 64, 512, 64), (2, 64, 1536, 64),
              (1, 64, 64, 16), (0, 64, 64, 64), (12, 9, 27, 3),
              (5, 96, 48, 16), (30, 64, 64, 64))
ROW_ELEM_SHAPES = ((200, 128, 1), (64, 1, 256))


def row_tables(stored, n: int) -> dict:
    """The row-stream body's check tables in ``stored``: "B1" chunked
    buckets of ``ROW_SHAPES`` whose chunk ids repeat and reach one chunk
    past n, "B9" element buckets of the same shapes and ``ROW_ELEM_SHAPES``
    with repeated rows and sentinel lanes (index n)."""
    rng = np.random.default_rng(19)
    np_dt = (np.float32 if stored == torch.bfloat16
             else torch.empty(0, dtype=stored).numpy().dtype)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    chunked, element = [], []
    for nb, mp, kp, C in ROW_SHAPES:
        vals = t(values_of(np_dt, rng, (nb, mp, kp))).to(stored).contiguous()
        chunked.append((vals, t(rng.integers(0, n // C + 1, (nb, mp // C))
                                .astype(np.int32)),
                        t(rng.integers(0, n // C + 1, (nb, kp // C))
                          .astype(np.int32)), C))
    for nb, mp, kp in [s_[:3] for s_ in ROW_SHAPES] + list(ROW_ELEM_SHAPES):
        ridx = rng.integers(0, n, (nb, mp)).astype(np.int32)
        cidx = rng.integers(0, n, (nb, kp)).astype(np.int32)
        ridx[::3, -1] = n
        cidx[1::4, 0] = n
        vals = t(values_of(np_dt, rng, (nb, mp, kp))).to(stored).contiguous()
        element.append((vals, t(ridx), t(cidx), 1))
    return {"B1": BucketTable(chunked), "B9": BucketTable(element)}


def rows_vs_plain(gen) -> dict:
    """The row-stream body (r = 1) of B1 and of B9's element pass, launched
    directly, against its plain version and against the tile core on the
    same tables (``row_tables``), every stored / compute pair x forward,
    transpose, symmetric (x conj for complex values), adding into an output
    that holds a partial sum."""
    errs = {"rows B1": 0.0, "rows B9": 0.0, "rows vs tile": 0.0}
    n = 2048
    plain = {"B1": fused_spmm.multi_block_apply_plain,
             "B9": mask_select.element_apply_plain}
    for stored, compute in VALUE_PAIRS:
        tables = row_tables(stored, n)
        x = torch.randn(n, generator=gen, dtype=compute).to(DEV)
        prior = torch.randn(n, generator=gen, dtype=compute).to(DEV)
        for kind, table in tables.items():
            for mode, kw in MODE_KW.items():
                for conj in ((False, True) if stored.is_complex else (False,)):
                    m = fused_spmm.launch_mode(mode == "transpose",
                                               mode == "symmetric", conj)
                    got, tile = prior.clone(), prior.clone()
                    tile_entry, rows_entry = fused_spmm.FMA_PREFIXES[kind]
                    fused_spmm.launch_table(rows_entry, table, x, got, m,
                                            rows=True)
                    fused_spmm.launch_table(tile_entry, table, x, tile, m)
                    ref = plain[kind](table, x, out=prior.clone(), conj=conj,
                                      **kw)
                    torch.cuda.synchronize()
                    label = (f"row-stream body {kind} "
                             f"{pair_name(stored, compute)} {len(table)} "
                             f"buckets {mode}"
                             f"{' conj' if conj else ''}")
                    errs[f"rows {kind}"] = max(errs[f"rows {kind}"], rel_check(
                        f"{label} vs its plain version", got, ref,
                        TOL[compute]))
                    errs["rows vs tile"] = max(errs["rows vs tile"], rel_check(
                        f"{label} vs the tile core", got, tile, TOL[compute]))
    print(f"  row-stream body (r = 1) against its plain version and the tile "
          f"core: every pair, mode and conj, B1 on {len(ROW_SHAPES)} chunked "
          f"buckets, B9 on {len(ROW_SHAPES) + len(ROW_ELEM_SHAPES)} element "
          f"buckets (tile shapes {ROW_SHAPES}, {ROW_ELEM_SHAPES})")
    return errs


# B1's tensor-core instances, as (key, numpy dtype of the values, stored,
# compute)
MMA_PAIRS = (("B1 mma", np.complex64, torch.complex64, torch.complex64),
             ("B1 mma f64", np.float64, torch.float64, torch.float64),
             ("B1 mma c128", np.complex128, torch.complex128,
              torch.complex128),
             ("B1 mma bf16->f32", np.float32, torch.bfloat16, torch.float32))
# the contraction depths of the depth check of the instances that sum in
# the tensor core's float32 (bf16 -> f32, complex64)
MMA_DEPTHS = (64, 256, 512, 1024, 2048, 8192)


def mma_table(np_dtype, stored, deep: int) -> tuple:
    """(table, n): ``b1_table``'s buckets (mixed chunks, sentinel chunk
    ids) in ``stored``, and a bucket of four 64 x ``deep`` blocks whose
    column chunks repeat and reach one chunk past n."""
    table, n = b1_table(np_dtype)
    rng = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    buckets = list(table.buckets) + [(
        t(values_of(np_dtype, rng, (4, 64, deep))),
        t(rng.integers(0, n // 64, (4, 1)).astype(np.int32)),
        t(rng.integers(0, n // 64 + 1, (4, deep // 64)).astype(np.int32)),
        64)]
    return BucketTable([(v.to(stored).contiguous(), rt, ct, c)
                        for v, rt, ct, c in buckets]), n


def mma_instances_vs_plain(gen) -> dict:
    """B1's tensor-core instances (complex64, float64, complex128, bf16 ->
    float32) over a table of chunked buckets (mixed chunks, chunk ids past
    n, and the deepest block the rule admits: its cap where it has one,
    else 4096 columns) against their plain version and the FMA instance on
    the same table, forward, transpose, symmetric (x conj for complex
    values) x r in {2, 16, 64, 200}, adding into an output that holds a
    partial sum; then the bf16 and complex64 instances' error against a
    float64 product by contraction depth (``MMA_DEPTHS``), within 1e-5 at
    every depth up to each cap of ``fused_spmm.MMA_RULES`` (each cap: the
    deepest depth of the check within that)."""
    errs = {}
    for key, np_dtype, stored, compute in MMA_PAIRS:
        cap = fused_spmm.MMA_RULES[(stored, compute)].max_depth
        table, n = mma_table(np_dtype, stored, cap or 4096)
        require(fused_spmm.b1_instance(stored, compute, 2, table.depth) ==
                "mma", f"{key}: the rule must admit the table's depth")
        errs[key] = errs[f"{key} vs fma"] = 0.0
        for r in (2, 16, 64, 200):
            x = torch.randn((n, r), generator=gen, dtype=compute).to(DEV)
            prior = torch.randn(x.shape, generator=gen, dtype=compute).to(DEV)
            for mode, kw in MODE_KW.items():
                for conj in ((False, True) if stored.is_complex else (False,)):
                    mode_ = fused_spmm.launch_mode(mode == "transpose",
                                                   mode == "symmetric", conj)
                    got, fma = prior.clone(), prior.clone()
                    fused_spmm._launch_mma(table, x, got, mode_)
                    fused_spmm.launch_table("bst_fused_spmm_multi", table, x,
                                            fma, mode_)
                    ref = fused_spmm.mma_apply_plain(
                        table, x, out=prior.clone(), conj=conj, **kw)
                    torch.cuda.synchronize()
                    label = (f"{key} {len(table)} buckets (depth "
                             f"{table.depth}) {mode}{' conj' if conj else ''}"
                             f" r={r}")
                    errs[key] = max(errs[key], rel_check(
                        f"{label} vs its plain version", got, ref,
                        TOL[compute]))
                    errs[f"{key} vs fma"] = max(errs[f"{key} vs fma"],
                                                rel_check(
                        f"{label} vs the FMA instance", got, fma,
                        TOL[compute]))
    depth = {}
    for stored, compute in ((torch.bfloat16, torch.float32),
                            (torch.complex64, torch.complex64)):
        np_dt = np.complex64 if stored.is_complex else np.float32
        wide = torch.complex128 if stored.is_complex else torch.float64
        cap = fused_spmm.MMA_RULES[(stored, compute)].max_depth
        for D in MMA_DEPTHS:
            rng = np.random.default_rng(D)
            vals = torch.from_numpy(values_of(np_dt, rng, (16, 64, D))).to(
                stored).to(DEV).contiguous()
            rc = torch.from_numpy(rng.integers(0, 64, (16, 1)).astype(
                np.int32)).to(DEV)
            cc = torch.from_numpy(rng.integers(0, 64, (16, D // 64)).astype(
                np.int32)).to(DEV)
            table = BucketTable([(vals, rc, cc, 64)])
            wtable = BucketTable([(vals.to(wide), rc, cc, 64)])
            x = torch.randn((4096, 64), generator=gen, dtype=compute).to(DEV)
            for transpose in (False, True):
                got = torch.zeros_like(x)
                fused_spmm._launch_mma(table, x, got, int(transpose))
                ref = fused_spmm.multi_block_apply_plain(
                    wtable, x.to(wide), out=torch.zeros(x.shape, dtype=wide,
                                                        device=DEV),
                    transpose=transpose)
                torch.cuda.synchronize()
                e, _ = abs_err(f"{pair_name(stored, compute)} depth {D}",
                               got, ref, TOL[compute] if D <= cap
                               else float("inf"))
                rel = e / max(1.0, float(ref.abs().max()))
                depth[(pair_name(stored, compute), D, transpose)] = rel
    print("  tensor-core instances' error against a float64 product by "
          "contraction depth (of max|y|; forward / transpose, r = 64): "
          + "; ".join(f"{p} {D}: {depth[(p, D, False)]:.2e} / "
                      f"{depth[(p, D, True)]:.2e}"
                      for p, D, t in depth if not t)
          + "; caps: " + ", ".join(
              f"{pair_name(s_, c_)} {r_.max_depth}"
              for (s_, c_), r_ in fused_spmm.MMA_RULES.items()
              if r_.max_depth is not None))
    errs["mma depth"] = {f"{p} {D}{' transpose' if t else ''}": v
                         for (p, D, t), v in depth.items()}
    return errs


def phase1():
    print("phase 1: kernels against their plain versions")
    errs = {"B1": 0.0}
    gen = torch.Generator(device="cpu").manual_seed(5)
    for np_dtype, dtype in ((np.float32, torch.float32),
                            (np.float64, torch.float64)):
        for label, vals, rc, cc, C, n in b1_cases(np_dtype):
            for r in (1, 64, 200):
                X = torch.randn((n, r), generator=gen, dtype=dtype).to(DEV)
                x = X[:, 0].contiguous() if r == 1 else X
                for mode in ("forward", "transpose", "symmetric"):
                    kw = dict(transpose=mode == "transpose",
                              symmetric=mode == "symmetric")
                    got = fused_spmm.chunked_block_apply(vals, rc, cc, C, x, n, **kw)
                    ref = fused_spmm.chunked_block_apply_plain(vals, rc, cc, C, x, n, **kw)
                    torch.cuda.synchronize()
                    err = rel_check(f"B1 {dtype} {label} {mode} r={r}", got,
                                    ref, TOL[dtype])
                    errs["B1"] = max(errs["B1"], err)
    errs.update(b1_multi_vs_plain(gen))
    blocks, rows, cols, shape = random_block_sparse(
        4, shape=(2048, 2048), nblocks=150, max_block=120, dtype=np.float64,
        contiguous=True)
    A = bt.BlockSparseMatrix([b.astype(np.float32) for b in blocks], rows,
                             cols, shape, device=DEV)
    plan, dev = A._patch_for()
    vals, cc, rs, _mk = dev[0]
    patch_bucket = (vals, cc, rs, shape[0])
    bsm_bucket = dev[0]
    shape_b2 = shape
    print(f"  patch plan: {plan.buckets[0].nb} slots of "
          f"{plan.buckets[0].MP}x{plan.buckets[0].KP}")
    errs.update(b2_vs_plain(gen, patch_bucket))
    errs["B3"] = errs["B3 tf32"] = 0.0
    d, di, o, ri, ci, shape = random_symmetric(
        3, n=1024, ngroups=12, noffdiag=20, dtype=np.float32, contiguous=True)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device=DEV)
    for tm in (False, True):
        plan, dev = S._patch_for(tm)
        vals, cc, rs, mk = dev[0]
        print(f"  symmetric patch plan (transpose_main={tm}): "
              f"{plan.buckets[0].nb} slots of {plan.buckets[0].MP}x"
              f"{plan.buckets[0].KP}, {int(mk.sum())} mirrored chunks")
        for r in (32, 64, 128, 300):
            X = torch.randn((shape[0], r), generator=gen).to(DEV)
            for adj in (False, True):
                ref = patch_engine.bucket_spmm_sym_plain(vals, cc, rs, mk, X,
                                                         adjoint=adj)
                for prec, key in (("highest", "B3"), (None, "B3 tf32")):
                    got = patch_engine.bucket_spmm_sym(
                        vals, cc, rs, mk, X, adjoint=adj, precision=prec,
                        owners=dev[0].owners[adj])
                    torch.cuda.synchronize()
                    errs[key] = max(errs[key], rel_check(
                        f"B3 {'adjoint' if adj else 'symmetric'} "
                        f"transpose_main={tm} r={r} precision={prec}", got,
                        ref, TIER_TOL[prec]))
    errs["B9 gather"] = errs["B9 scatter"] = 0.0
    rng = np.random.default_rng(12)
    for n, K in ((32768, 1 << 20), (1000, 50000)):
        idx = rng.integers(0, n, K).astype(np.int32)
        idx[::7] = n  # the layout's sentinel
        x = torch.randn(n, generator=gen).to(DEV)
        v = torch.randn(K, generator=gen).to(DEV)
        ti = torch.from_numpy(idx).to(DEV)
        for kind, got, ref in (
                ("gather", mask_select.mask_gather(x, ti),
                 mask_select.mask_gather_plain(x, ti)),
                ("scatter", mask_select.mask_scatter_add(v, ti, n),
                 mask_select.mask_scatter_add_plain(v, ti, n))):
            torch.cuda.synchronize()
            err = rel_check(f"B9 {kind} n={n} K={K}", got, ref,
                            TOL[torch.float32])
            errs[f"B9 {kind}"] = max(errs[f"B9 {kind}"], err)
    errs.update(element_vs_plain(gen))
    errs.update(complex_vs_plain(gen))
    errs.update(rows_vs_plain(gen))
    errs.update(owner_vs_plain(gen))
    errs.update(rounds_vs_plain(gen))
    errs.update(colored_vs_plain(gen))
    errs.update(mma_instances_vs_plain(gen))
    stream_errs, panel_plans = stream_kernels_vs_plain(gen)
    errs.update(stream_errs)
    errs.update(batched_kernels_vs_plain(gen, patch_bucket, panel_plans))
    W = wide_patch_operator(DEV)
    wplan, wdev = W._patch_for()
    wb = wplan.buckets[0]
    require(wb.G % 8 != 0 and int(wb.row_start.max()) + wb.MP > W.shape[0],
            "the wide plan must have G % 8 != 0 and windows past n")
    print(f"  wide patch plan: {wb.nb} slots of {wb.MP}x{wb.KP}, G={wb.G}")
    WS = wide_symmetric_operator(DEV)
    wsb = WS._patch_for(False)[1][0]
    require(wsb[0].shape[2] == 2048 and int(wsb[3].min()) > 0,
            "the wide symmetric plan must have KP = 2048 and mirrored chunks")
    errs.update(b7_vs_plain(gen, [
        ("BSM plan", bsm_bucket, shape_b2[0]),
        (f"wide plan (G={wb.G}, windows past n)", wdev[0], W.shape[0])]
        + [(f"symmetric plan transpose_main={tm}", S._patch_for(tm)[1][0],
            S.shape[0]) for tm in (False, True)]
        + [("wide symmetric plan", wsb, WS.shape[0]),
           ("wide symmetric plan with zero row tiles and all-zero slots",
            with_dead_slots(wsb, WS.shape[0]), WS.shape[0])]))
    errs.update(b7_nonfinite(gen, W, wdev[0]))
    errs.update(b10_vs_plain(gen))
    return errs


def b2_vs_plain(gen, patch_bucket) -> dict:
    """B2 on three plans: phase 1's (8-row slots), one of 48-row slots (MP
    not a multiple of 32: the transpose's last window box holds rows of
    other slots) and one of 128-row slots (two 64-row blocks each).  Its
    prologue against the plain split (hi bit-equal, hi + lo == X; at P = 3
    one launch, held product by product), the forward and the transpose at
    both tiers against the plain version (TOL32 at "highest", TOL_TF32 at
    None), the transpose also at P in {2, 4} (batched_mm's dX) against
    batched_spmm_plain and against P single transposes; the duality of the
    wgmma forward with B4's forward instance at P = 1; on the 48-row plan,
    inf / NaN in the rows of X that no window covers (the result stays
    finite and equal to the plain version) and the duality of the transpose
    with the forward on the plan of the transposed layout.  r in {6, 302}
    (r % 4 != 0) takes the transpose's atomicAdd epilogue and the
    prologue's scalar loads, the other r the TMA reduce-add.  Last, the
    transpose's launch geometry (``patch_engine.tr_geometry``) on known
    shapes."""
    errs = {"B2": 0.0, "B2 tf32": 0.0, "B2 duality": 0.0, "B2 prologue": 0.0,
            "B2 transpose": 0.0, "B2 transpose tf32": 0.0,
            "B2 transpose duality": 0.0}
    plans = {"8-row": patch_bucket}
    mid, _ = contiguous_operator(1536, 40, 48, seed=16, value_seed=None,
                                 device=DEV)
    mplan, mdev = mid._patch_for()
    require(mplan.buckets[0].MP % 32 != 0, "the second B2 plan must have "
            f"slots of a non-multiple of 32 rows, got {mplan.buckets[0].MP}")
    plans["48-row"] = (*mdev[0][:3], 1536)
    wide, _ = contiguous_operator(2048, 150, 128, seed=15, value_seed=None,
                                  device=DEV)
    plan, dev = wide._patch_for()
    require(plan.buckets[0].MP == 128, "the third B2 plan must have "
            f"128-row slots, got {plan.buckets[0].MP}")
    plans["128-row"] = (*dev[0][:3], 2048)
    for label, (vals, cc, rs, n) in plans.items():
        print(f"  B2 plan of {label} slots: {vals.shape[0]} slots of "
              f"{vals.shape[1]}x{vals.shape[2]}")
    for label, (vals, cc, rs, n) in plans.items():
        for r in B2_R:
            X = torch.randn((n, r), generator=gen).to(DEV)
            for tier in (0, 1):
                hi, lo = patch_engine.patch_xt(X, tier)
                phi, plo = patch_engine.patch_xt_plain(X, tier)
                torch.cuda.synchronize()
                require(torch.equal(hi[:, :n], phi[:, :n]),
                        f"B2 prologue r={r} tier {tier}: hi differs from tf32(X)^T")
                if tier:
                    require(torch.equal(hi[:, :n] + lo[:, :n], X.t()),
                            f"B2 prologue r={r}: hi + lo != X")
                    errs["B2 prologue"] = max(errs["B2 prologue"], float(
                        (lo[:, :n] - plo[:, :n]).abs().max()))
            for tr in (False, True):
                ref = patch_engine.bucket_spmm_plain(vals, cc, rs, X, n,
                                                     transpose=tr)
                for prec in ("highest", None):
                    key = ("B2 transpose" if tr else "B2") + (
                        " tf32" if prec is None else "")
                    got = patch_engine.bucket_spmm(vals, cc, rs, X, n,
                                                   transpose=tr, precision=prec)
                    torch.cuda.synchronize()
                    errs[key] = max(errs[key], rel_check(
                        f"B2 {'transpose' if tr else 'forward'} {label} "
                        f"MP={vals.shape[1]} r={r} precision={prec}", got,
                        ref, TIER_TOL[prec]))
            other = batched_spmm.batched_spmm(vals[None], cc, rs, X[None], n)[0]
            got = patch_engine.bucket_spmm(vals, cc, rs, X, n)
            torch.cuda.synchronize()
            errs["B2 duality"] = max(errs["B2 duality"], rel_check(
                f"B2 forward {label} r={r} vs B4's forward at P=1", got, other,
                TOL32))
            for P in (2, 4):
                vals_b = vals[None] * torch.randn((P,) + tuple(vals.shape),
                                                  generator=gen).to(DEV)
                Xb = torch.randn((P, n, r), generator=gen).to(DEV)
                name = f"B2 transpose {label} P={P} r={r}"
                ref = batched_spmm.batched_spmm_plain(vals_b, cc, rs, Xb, n,
                                                      transpose=True)
                loop = torch.stack([patch_engine.bucket_spmm(
                    vals_b[p], cc, rs, Xb[p], n, transpose=True)
                    for p in range(P)])
                for prec in ("highest", None):
                    key = "B2 transpose" + (" tf32" if prec is None else "")
                    got = batched_spmm.batched_spmm(
                        vals_b, cc, rs, Xb, n, transpose=True, precision=prec)
                    torch.cuda.synchronize()
                    errs[key] = max(errs[key], rel_check(
                        f"{name} precision={prec} vs plain", got, ref,
                        TIER_TOL[prec]))
                    if prec == "highest":
                        errs["B2 transpose duality"] = max(
                            errs["B2 transpose duality"], rel_check(
                                f"{name} vs {P} single transposes", got, loop,
                                TOL32))
        print(f"  B2 prologue {label} n={n}: hi bit-equal to the plain "
              f"tf32(X)^T at both tiers, hi + lo == X exactly, r in {B2_R}")
    # the prologue's product axis: one launch for three products
    vals, cc, rs, n = plans["48-row"]
    Xb = torch.randn((3, n, 40), generator=gen).to(DEV)
    before = counts()
    hi, lo = patch_engine.patch_xt(Xb, 1)
    torch.cuda.synchronize()
    require(grown_since(before)["B2 prologue"] == 1,
            "the P-axis prologue must be one launch")
    for p in range(3):
        phi, _ = patch_engine.patch_xt_plain(Xb[p], 1)
        require(torch.equal(hi[p], phi) and torch.equal(
            hi[p, :, :n] + lo[p, :, :n], Xb[p].t()),
            f"B2 prologue P=3: product {p} differs from its plain split")
    print("  B2 prologue P=3: one launch, each product's hi bit-equal to its "
          "plain split, hi + lo == X")
    # inf / NaN in the rows of X that no window covers
    MP = vals.shape[1]
    covered = torch.zeros(n, dtype=torch.bool)
    reach = torch.zeros(n, dtype=torch.bool)  # read by a window's last box
    for w in rs.tolist():
        covered[w:w + MP] = True
        reach[w + MP:w + -(-MP // 32) * 32] = True
    bad = ~covered
    require(bool((bad & reach).any()), "the 48-row plan must leave rows "
            "inside a window's last box uncovered")
    X = torch.randn((n, 64), generator=gen)
    X[bad] = float("inf")
    X[bad.nonzero()[::2, 0]] = float("nan")
    X = X.to(DEV)
    ref = patch_engine.bucket_spmm_plain(vals, cc, rs, X, n, transpose=True)
    require(bool(torch.isfinite(ref).all()), "the plain version must not "
            "read uncovered rows")
    for prec in ("highest", None):
        key = "B2 transpose" + (" tf32" if prec is None else "")
        got = patch_engine.bucket_spmm(vals, cc, rs, X, n, transpose=True,
                                       precision=prec)
        torch.cuda.synchronize()
        errs[key] = max(errs[key], rel_check(
            f"B2 transpose 48-row, inf/NaN in {int(bad.sum())} uncovered rows "
            f"({int((bad & reach).sum())} inside last window boxes) "
            f"precision={prec}", got, ref, TIER_TOL[prec]))
    # duality: A.T @ X by the transpose against the forward on A^T's plan
    midT, _ = contiguous_operator(1536, 40, 48, seed=16, value_seed=None,
                                  device=DEV, transposed=True)
    tplan, tdev = midT._patch_for()
    X = torch.randn((n, 64), generator=gen).to(DEV)
    before = counts()
    Yt = patch_engine.patch_spmm(mplan, mdev, X, transpose=True)
    grown_t = grown_since(before)
    before = counts()
    Yf = patch_engine.patch_spmm(tplan, tdev, X)
    grown_f = grown_since(before)
    torch.cuda.synchronize()
    require(grown_t["B2 transpose"] >= 1 and grown_t["B2"] == 0
            and grown_f["B2"] >= 1 and grown_f["B2 transpose"] == 0,
            f"duality routes: {grown_t}, {grown_f}")
    errs["B2 transpose duality"] = max(errs["B2 transpose duality"], rel_check(
        f"B2 transpose 48-row r=64 vs B2's forward on the transposed "
        f"layout's plan ({tplan.buckets[0].nb} slots of "
        f"{tplan.buckets[0].MP}x{tplan.buckets[0].KP})", Yt, Yf, TOL32))
    for case, want in TR_GEOMETRY:
        got = patch_engine.tr_geometry(*case)
        require(got == want, f"B2 transpose geometry {case}: (TR, group, "
                f"blocks) {got}, expected {want}")
    print(f"  B2 transpose geometry: {len(TR_GEOMETRY)} known shapes give the "
          f"expected (TR, group, blocks)")
    return errs


B2_R = (6, 8, 64, 128, 300, 302)   # phase 1's widths for B2

# (P, nb, MP, KP, r, tier, SMs) -> (TR, group, blocks) of B2's transpose
TR_GEOMETRY = (
    # phase 3's operand (358 slots of 128 x 768, r = 128) on 132 SMs: one
    # block per slot, all twelve 64-row tiles of it, at both tiers
    ((1, 358, 128, 768, 128, 1, 132), (128, 12, 358)),
    ((1, 358, 128, 768, 128, 0, 132), (128, 12, 358)),
    # 192-row slots at tier 1: hi and lo windows of TR = 128 (192 KB) do not
    # fit beside the rings, TR = 64 does (two column tiles: 100 blocks, one
    # wave); at tier 0 TR = 128 fits and two blocks per slot fill the wave
    ((1, 50, 192, 256, 128, 1, 132), (64, 4, 100)),
    ((1, 50, 192, 256, 128, 0, 132), (128, 2, 100)),
    # a few slots: groups of three tiles fill one wave of 120 blocks
    ((1, 10, 8, 768, 300, 0, 132), (128, 3, 120)),
    # r <= 64 takes TR = 64; the product axis multiplies the grid
    ((4, 358, 128, 768, 40, 1, 132), (64, 12, 1432)),
)


def check_stream_kernel(name, kernel, plain, plan, dev, x, errs):
    """One stream kernel against its plain version, and its duality check:
    one tile per warp (every row sum an atomic add) against 16 (sums
    carried in registers across a row chunk's tiles)."""
    ref = plain(plan, dev, x)
    one = kernel(plan, dev, x, tiles_per_warp=1)
    many = kernel(plan, dev, x, tiles_per_warp=16)
    auto = kernel(plan, dev, x)
    torch.cuda.synchronize()
    key = name.split()[0]
    for label, got in (("tpw=1", one), ("tpw=16", many), ("auto", auto)):
        errs[key] = max(errs[key], rel_check(f"{name} {label} vs plain", got,
                                             ref, TOL[torch.float32]))
    errs[f"{key} duality"] = max(errs[f"{key} duality"], rel_check(
        f"{name} duality: tpw=1 vs tpw=16", one, many, TOL[torch.float32]))


def wide_mirror_plan():
    """A mirror plan whose 408 compact chunks in one slab leave too little
    shared memory for B5's mirror accumulator beside its ring, so B5 takes
    its direct mode: rows 0-7 hold a diagonal block and 400 stored
    off-diagonal 8 x 128 blocks at distinct chunks on grid 4, the last
    one cut at n = 51300 (its segment runs past ncols)."""
    ents, n = wide_mirror_entries()
    return build_panel_plan(ents, (n, n), mirror=True)


def split_span(plan) -> int | None:
    """Tiles per block that cut the plan's stream with a block boundary
    inside a live row chunk (ranges that split a slab and a row chunk),
    into fewer blocks than slabs where the plan has more than two; None
    where no row chunk spans two tiles."""
    ntiles, rid = plan.S * plan.TS, plan.rid8.reshape(-1)
    start = -(-ntiles // (plan.S - 1)) if plan.S > 2 else 2
    for span in range(start, ntiles):
        cuts = np.arange(span, ntiles, span)
        if any(c % plan.TS and rid[c] < plan.RW and rid[c] == rid[c - 1]
               for c in cuts):
            return span
    return None


def b5_launch_text(plan) -> str:
    g = panel_spmv.panel_geometry(plan)
    return (f"B5 launch: {g['mode']} mode, {g['stages']} ring stages of "
            f"32 KB, {g['smem'] / 1024:.1f} KB shared memory, "
            f"{g['per_sm']} blocks per SM, {g['blocks']} blocks x "
            f"{g['tiles_per_block']} tiles")


def check_b5(label, plan, dev, x, errs, span=None) -> str:
    """B5 against its plain version at launch geometries of one tile per
    block (every sum an atomic add into y), the whole stream in one block
    (every sum meets in shared memory), ``span`` tiles per block where
    given, and the kernel's own; its duality check holds the first two
    against each other.  Returns the plan's B5 mode."""
    ntiles = plan.S * plan.TS
    ref = panel_spmv.panel_apply_plain(plan, dev, x)
    runs = {t: panel_spmv.panel_spmv(plan, dev, x, tiles_per_block=t)
            for t in dict.fromkeys((1, ntiles, span, None))}
    torch.cuda.synchronize()
    for t, got in runs.items():
        errs["B5"] = max(errs["B5"], rel_check(
            f"B5 {label} tiles_per_block={t or 'auto'} vs plain", got, ref,
            TOL32))
    errs["B5 duality"] = max(errs["B5 duality"], rel_check(
        f"B5 {label} duality: tiles_per_block=1 vs {ntiles}", runs[1],
        runs[ntiles], TOL32))
    return panel_spmv.panel_geometry(plan)["mode"]


def b5_vs_plain(gen, plans) -> dict:
    """:func:`check_b5` on each plan, with ranges that split slabs and row
    chunks over fewer blocks than slabs (:func:`split_span`); the plans
    drive B5's three modes: plain, mirror (sums in shared memory) and
    mirror direct."""
    errs = {"B5": 0.0, "B5 duality": 0.0}
    modes, fewer = set(), []
    for label, plan in plans.items():
        dev = panel_spmv.panel_device_arrays(plan, DEV)
        x = torch.randn(plan.ncols, generator=gen).to(DEV)
        span = split_span(plan)
        blocks = None if span is None else -(-plan.S * plan.TS // span)
        print(f"  B5 {label}: {describe(plan)}; {b5_launch_text(plan)}; "
              f"ranges splitting a row chunk: "
              f"{'none' if span is None else f'{span} tiles, {blocks} blocks'}")
        if span is not None and blocks < plan.S:
            fewer.append(label)
        modes.add(check_b5(label, plan, dev, x, errs, span))
    require(modes == set(panel_spmv.PANEL_MODES),
            f"phase 1 must drive every B5 mode, drove {sorted(modes)}")
    require(fewer, "no plan ran with fewer blocks than slabs")
    return errs


def stream_kernels_vs_plain(gen):
    """B5 and B8 on small plans: plain, transposed, fused mirror with
    shifted grids (and one of five slabs), a last segment past ncols, a
    mirror plan of B5's direct mode; slab plain and mirror.  Returns the
    errors and the panel plans."""
    errs = {"B8": 0.0, "B8 duality": 0.0}
    blocks, rows, cols, shape = random_block_sparse(
        11, shape=(600, 600), nblocks=30, max_block=60, dtype=np.float32,
        contiguous=True)
    lay = build_layout(blocks, rows, cols, shape)
    d, di, o, ri, ci, shp = random_symmetric(
        13, n=700, ngroups=14, noffdiag=26, dtype=np.float32, contiguous=True)
    dl, ol = build_layout(d, di, di, shp), build_layout(o, ri, ci, shp)
    fused = (_layout_entries(dl, transpose=False)
             + [(b, r, c, True) for b, r, c, _ in
                _layout_entries(ol, transpose=False)])
    d2 = random_symmetric(8, n=4096, ngroups=48, noffdiag=160,
                          dtype=np.float32, contiguous=True)
    rng = np.random.default_rng(23)
    wrap = [(rng.standard_normal((40, 30)).astype(np.float32),
             np.arange(0, 40), np.arange(980, 1010), False),
            (rng.standard_normal((24, 100)).astype(np.float32),
             np.arange(40, 64), np.arange(300, 400), False)]
    plans = {
        "plain": panel_plan_from_layout(lay),
        "transposed": panel_plan_from_layout(lay, transpose=True),
        "fused mirror": build_panel_plan(fused, shp, mirror=True),
        "fused mirror, config-2 recipe n=4096": core_panel.symmetric_candidates(
            build_layout(d2[0], d2[1], d2[1], d2[5]),
            build_layout(*d2[2:]))[0],
        "wrap": build_panel_plan(wrap, (64, 1010)),
        "wide mirror": wide_mirror_plan(),
    }
    require(plans["fused mirror"].mirror and
            len(plans["fused mirror"].grids_used) > 1,
            "the fused plan must mirror on shifted grids")
    require(20 in plans["wrap"].grids_used, "the wrap plan must use grid 20")
    require(plans["fused mirror, config-2 recipe n=4096"].S >= 4,
            "the config-2 fused plan must have several slabs")
    errs.update(b5_vs_plain(gen, plans))
    splans = {"plain": plan_from_layout(lay),
              "transposed": plan_from_layout(lay, transpose=True),
              "mirror": plan_symmetric(dl, ol),
              "mirror, transposed diagonal": plan_symmetric(
                  dl, ol, transpose_diag=True)}
    for label, plan in splans.items():
        dev = slab_spmv.plan_device_arrays(plan, DEV)
        x = torch.randn(plan.ncols, generator=gen).to(DEV)
        check_stream_kernel(f"B8 {label} (S={plan.S} TS={plan.TS})",
                            slab_spmv.slab_spmv, slab_spmv.slab_apply_plain,
                            plan, dev, x, errs)
    return errs, plans


def batched_kernels_vs_plain(gen, patch_bucket, panel_plans):
    """B4 (forward; its transpose is B2's, checked in b2_vs_plain) on phase
    1's patch plan and B6 on its panel plans: P products whose values are
    the plan's own scaled entry by entry (padding stays zero), against the
    plain versions, and the duality checks: B4 against P launches of B2, B6
    at 1 against 16 tiles per warp and against P launches of B5."""
    errs = {"B4": 0.0, "B4 tf32": 0.0, "B4 duality": 0.0, "B6": 0.0,
            "B6 duality": 0.0}
    vals, cc, rs, n = patch_bucket

    def planes(v, P):
        return v[None] * torch.randn((P,) + tuple(v.shape), generator=gen).to(DEV)

    for P in (2, 4):
        vals_b = planes(vals, P)
        for r in (8, 64, 128, 264):
            X = torch.randn((P, n, r), generator=gen).to(DEV)
            name = f"B4 forward P={P} r={r}"
            got = batched_spmm.batched_spmm(vals_b, cc, rs, X, n)
            fast = batched_spmm.batched_spmm(vals_b, cc, rs, X, n,
                                             precision=None)
            ref = batched_spmm.batched_spmm_plain(vals_b, cc, rs, X, n)
            loop = torch.stack([patch_engine.bucket_spmm(
                vals_b[p], cc, rs, X[p], n) for p in range(P)])
            torch.cuda.synchronize()
            errs["B4"] = max(errs["B4"], rel_check(
                f"{name} precision=highest vs plain", got, ref, TOL32))
            errs["B4 tf32"] = max(errs["B4 tf32"], rel_check(
                f"{name} precision=None vs plain", fast, ref, TOL_TF32))
            errs["B4 duality"] = max(errs["B4 duality"], rel_check(
                f"{name} vs {P} B2 launches", got, loop, TOL32))
    for label, plan in panel_plans.items():
        tables = panel_spmv.panel_id_tables(plan, DEV)
        for P in (2, 5):
            vals_b = planes(torch.from_numpy(plan.vals).to(DEV), P)
            xb = torch.randn((P, plan.ncols), generator=gen).to(DEV)
            name = f"B6 {label} P={P}"
            ref = panel_spmv.panel_apply_batched_plain(plan, tables, vals_b, xb)
            runs = {f"tpw={t or 'auto'}": panel_spmv.panel_spmv_batched(
                plan, tables, vals_b, xb, tiles_per_warp=t) for t in (1, 16, None)}
            loop = torch.stack([panel_spmv.panel_spmv(plan, (vals_b[p],) + tables,
                                                      xb[p]) for p in range(P)])
            torch.cuda.synchronize()
            for key, got in runs.items():
                errs["B6"] = max(errs["B6"], rel_check(
                    f"{name} {key} vs plain", got, ref, TOL32))
            errs["B6 duality"] = max(
                errs["B6 duality"],
                rel_check(f"{name} duality: tpw=1 vs tpw=16", runs["tpw=1"],
                          runs["tpw=16"], TOL32),
                rel_check(f"{name} vs {P} B5 launches", runs["tpw=auto"], loop,
                          TOL32))
    return errs


def wide_patch_operator(device):
    """Five 120 x 1000 f32 blocks in a 2030^2 matrix: the patch plan has one
    slot per canvas of 128 x 1024 (G = 1, where the JAX package's r = 1
    kernel does not run) and row windows that run past n."""
    rng = np.random.default_rng(14)
    n, starts = 2030, [(0, 0), (256, 1000), (1910, 0), (1910, 1000),
                       (640, 512)]
    rows = [np.arange(r, r + 120) for r, _ in starts]
    cols = [np.arange(c, min(c + 1000, n)) for _, c in starts]
    blocks = [rng.standard_normal((120, len(c))).astype(np.float32)
              for c in cols]
    return bt.BlockSparseMatrix(blocks, rows, cols, (n, n), device=device)


def with_dead_slots(bucket, n: int):
    """A copy of a plan bucket (vals, cc, rs, mk) with what B7's table
    skips: row tiles 1 and 3 of the first half of the slots zeroed, the
    last slot's values zeroed with every chunk a sentinel, the one before
    it all zero; its live row-tile table built anew."""
    vals, cc, rs, mk = (t.clone() for t in bucket[:4])
    nb = vals.shape[0]
    require(vals.shape[1] >= 32 and nb >= 4,
            "the dead-slot plan needs 4 row tiles and 4 slots")
    vals[:nb // 2, 8:16] = 0
    vals[:nb // 2, 24:32] = 0
    vals[nb - 2:] = 0
    cc[nb - 1] = -(-n // CC)
    tiles = torch.from_numpy(patch_spmv1.live_row_tiles(
        vals.cpu().numpy())).to(DEV)
    return patch_engine.BucketArrays((vals, cc, rs, mk), tiles=tiles)


def wide_symmetric_operator(device):
    """A symmetric operator whose patch plan has slots of 64 x 2048 (each
    128-column stretch owner warp of B7 holds two) with 62 mirrored chunks
    each: 32 diagonal groups of 64 rows, each with one stored off-diagonal
    block of 64 x 1984 at an aligned column offset past the groups."""
    rng = np.random.default_rng(16)
    d = [rng.standard_normal((64, 64)).astype(np.float32) for _ in range(32)]
    di = [np.arange(64 * g, 64 * g + 64) for g in range(32)]
    ci = [np.arange(2048 + 96 * g, 2048 + 96 * g + 1984) for g in range(32)]
    o = [rng.standard_normal((64, 1984)).astype(np.float32) for _ in range(32)]
    return bt.SymmetricBlockMatrix(d, di, o, di, ci, (7040, 7040),
                                   device=device)


def check_b7(label, bucket, x, n_out, mode, errs, other=None) -> None:
    """B7 against its plain version at one tile per block (every sum an
    atomic add into y), the whole table in one block (a slot's column sums
    meet in one owner warp) and the kernel's own geometry; its duality
    check holds the first two against each other, and against ``other``
    (B2 or B3 at r = 1 on the same plan) where given."""
    vals, cc, rs, mk = bucket
    tiles = bucket.tiles
    ref = patch_spmv1.patch_spmv1_plain(vals, cc, rs, mk, x, n_out, mode)
    runs = {t: patch_spmv1.patch_spmv1(vals, cc, rs, mk, x, n_out, mode,
                                       tiles=tiles, tiles_per_block=t)
            for t in dict.fromkeys((1, tiles.shape[0], None))}
    torch.cuda.synchronize()
    for t, got in runs.items():
        errs["B7"] = max(errs["B7"], rel_check(
            f"B7 {label} mode {mode} tiles_per_block={t or 'auto'} vs plain",
            got, ref, TOL32))
    errs["B7 duality"] = max(errs["B7 duality"], rel_check(
        f"B7 {label} mode {mode} duality: tiles_per_block=1 vs "
        f"{tiles.shape[0]}", runs[1], runs[tiles.shape[0]], TOL32))
    if other is not None:
        errs["B7 duality"] = max(errs["B7 duality"], rel_check(
            f"B7 {label} mode {mode} vs {other[0]} at r=1", runs[None],
            other[1], TOL32))


def b7_launch_text(bucket, mode: str) -> str:
    tiles = bucket.tiles
    g = patch_spmv1.patch_spmv1_geometry(tiles.shape[0], bucket[0].shape[2],
                                         mode)
    return (f"B7 launch (mode {mode}): {g['stages']} ring stages of 32 KB, "
            f"{g['smem'] / 1024:.1f} KB shared memory, {g['per_sm']} "
            f"blocks per SM, {g['blocks']} blocks x {g['tiles_per_block']} "
            f"row tiles")


def b7_vs_plain(gen, cases) -> dict:
    """B7 in modes f, t, m and a on each plan bucket of ``cases`` ((label,
    BucketArrays with its live row-tile table, n)), checked by
    :func:`check_b7` against its plain version at three launch geometries
    and against B2 (modes f, t) and B3 (modes m, a) at r = 1 on the same
    plan; then the non-finite case: on the G = 1 plan whose windows run
    past n (``wide``), x = inf at the rows only all-zero row tiles face,
    where B7 must give scipy's finite A^T x over the blocks."""
    errs = {"B7": 0.0, "B7 duality": 0.0, "B7 inf": 0.0}
    for label, bucket, n in cases:
        vals, cc, rs, mk = bucket
        nb, MP, KP = vals.shape
        tiles = bucket.tiles.cpu().numpy()
        print(f"  B7 {label}: {nb} slots of {MP}x{KP}, {len(tiles)} of "
              f"{nb * MP // 8} row tiles live, "
              f"{patch_spmv1.live_tile_bytes(tiles) / 1e6:.3f} of "
              f"{vals.numel() * 4 / 1e6:.3f} MB read; "
              f"{b7_launch_text(bucket, 'm')}")
        for mode in ("f", "t", "m", "a"):
            x = torch.randn(n, generator=gen).to(DEV)
            if mode in "ft":
                other = ("B2", patch_engine.bucket_spmm(
                    vals, cc, rs, x[:, None], n, transpose=mode == "t"))
            else:
                other = ("B3", patch_engine.bucket_spmm_sym(
                    vals, cc, rs, mk, x[:, None], adjoint=mode == "a"))
            check_b7(label, bucket, x, n, mode, errs,
                     (other[0], other[1][:, 0]))
    return errs


def b7_nonfinite(gen, W, bucket) -> dict:
    """B7 on the wide plan with x = inf at the rows that only all-zero row
    tiles face (modes t and a read x at a tile's rows; the plan's mk is 0,
    so a is t): the result must be finite and equal scipy's A^T x over the
    blocks, which never meets those rows; the plain version, which sums
    the plan's padding too, gives NaN there."""
    vals, cc, rs, mk = bucket
    n = W.shape[0]
    MT = vals.shape[1] // 8
    covered = np.zeros(n + vals.shape[1], bool)
    windows = np.zeros_like(covered)
    rs_h = rs.cpu().numpy()
    for t in bucket.tiles[:, 0].cpu().numpy():
        r0 = int(rs_h[t // MT]) + (t % MT) * 8
        covered[r0:r0 + 8] = True
    for r0 in rs_h:
        windows[r0:r0 + vals.shape[1]] = True
    faced = np.flatnonzero(windows[:n] & ~covered[:n])
    require(faced.size > 0,
            "the wide plan must have rows only zero row tiles face")
    xh = torch.randn(n, generator=gen).double()
    xh[torch.from_numpy(faced)] = float("inf")
    ref = bt.to_scipy(W).astype(np.float64).T @ xh.numpy()
    require(np.all(np.isfinite(ref)), "scipy's A^T x must stay finite")
    x = xh.float().to(DEV)
    err = 0.0
    for mode in ("t", "a"):
        got = patch_spmv1.patch_spmv1(vals, cc, rs, mk, x, n, mode,
                                      tiles=bucket.tiles)
        plain = patch_spmv1.patch_spmv1_plain(vals, cc, rs, mk, x, n, mode)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()),
                f"B7 mode {mode} with inf at {faced.size} rows only zero "
                f"tiles face gave a non-finite result")
        require(bool(torch.isnan(plain).any()),
                "the plain version must meet the inf (the check must bite)")
        err = max(err, rel_check(
            f"B7 mode {mode}, inf at {faced.size} rows only zero row tiles "
            f"face, vs scipy over the blocks", got, ref, TOL32))
    return {"B7 inf": err}


def check_b10(label, plan, dev, x, errs, span=None) -> str:
    """B10 against its plain version at one tile per block, the whole
    stream in one block, ``span`` tiles per block (ranges that split slabs
    and row chunks) where given, and the kernel's own geometry; its duality
    check holds the first two against each other.  Returns the plan's
    mode."""
    ntiles = plan.S * plan.TS
    ref = panel2_spmv.panel2_apply_plain(plan, dev, x)
    runs = {t: panel2_spmv.panel2_spmv(plan, dev, x, tiles_per_block=t)
            for t in dict.fromkeys((1, ntiles, span, None))}
    torch.cuda.synchronize()
    for t, got in runs.items():
        errs["B10"] = max(errs["B10"], rel_check(
            f"B10 {label} tiles_per_block={t or 'auto'} vs plain", got, ref,
            TOL32))
    errs["B10 duality"] = max(errs["B10 duality"], rel_check(
        f"B10 {label} duality: tiles_per_block=1 vs {ntiles}", runs[1],
        runs[ntiles], TOL32))
    return panel2_spmv.panel2_geometry(plan)["mode"]


def b10_launch_text(plan) -> str:
    g = panel2_spmv.panel2_geometry(plan)
    return (f"B10 launch: {g['mode']} mode, {g['stages']} ring stages of "
            f"32 KB, {g['smem'] / 1024:.1f} KB shared memory, "
            f"{g['per_sm']} blocks per SM, {g['blocks']} blocks x "
            f"{g['tiles_per_block']} tiles")


def wide_mirror_entries():
    """The entries of :func:`wide_mirror_plan`: a diagonal block and 400
    stored off-diagonal 8 x 128 blocks at distinct chunks of one slab."""
    rng = np.random.default_rng(29)
    n = 51300
    ents = [(rng.standard_normal((8, 8)).astype(np.float32), np.arange(8),
             np.arange(8), False)]
    for c in range(1, 401):
        c0 = 128 * c + 4
        cols = np.arange(c0, min(c0 + 128, n))
        ents.append((rng.standard_normal((8, cols.size)).astype(np.float32),
                     np.arange(8), cols, True))
    return ents, n


def b10_vs_plain(gen) -> dict:
    """B10 on v2 plans at seg 8, 16 and 32: plain, transposed, fused mirror,
    a mirror plan whose compact chunks take the direct mode, and a plan
    whose last segment runs past ncols (1010 columns), each through
    :func:`check_b10` (ranges that split slabs where the plan has them);
    every seg drives the three modes."""
    errs = {"B10": 0.0, "B10 duality": 0.0}
    blocks, rows, cols, shape = random_block_sparse(
        11, shape=(600, 600), nblocks=30, max_block=60, dtype=np.float32,
        contiguous=True)
    lay = build_layout(blocks, rows, cols, shape)
    d, di, o, ri, ci, shp = random_symmetric(
        13, n=700, ngroups=14, noffdiag=26, dtype=np.float32, contiguous=True)
    dl, ol = build_layout(d, di, di, shp), build_layout(o, ri, ci, shp)
    fused = (panel2._layout_entries(dl, transpose=False)
             + [(b, r, c, True) for b, r, c, _ in
                panel2._layout_entries(ol, transpose=False)])
    d2 = random_symmetric(8, n=4096, ngroups=48, noffdiag=160,
                          dtype=np.float32, contiguous=True)
    fused2 = (panel2._layout_entries(build_layout(d2[0], d2[1], d2[1], d2[5]),
                                     transpose=False)
              + [(b, r, c, True) for b, r, c, _ in panel2._layout_entries(
                  build_layout(*d2[2:]), transpose=False)])
    wide, nw = wide_mirror_entries()
    rng = np.random.default_rng(23)
    wrap = [(rng.standard_normal((40, 30)).astype(np.float32),
             np.arange(0, 40), np.arange(980, 1010), False),
            (rng.standard_normal((24, 100)).astype(np.float32),
             np.arange(40, 64), np.arange(300, 400), False)]
    fewer = []
    for seg in (8, 16, 32):
        plans = {
            "plain": panel2.build_panel2_plan(
                panel2._layout_entries(lay, transpose=False), shape, seg=seg),
            "transposed": panel2.build_panel2_plan(
                panel2._layout_entries(lay, transpose=True), shape[::-1],
                seg=seg),
            "fused mirror": panel2.build_panel2_plan(fused, shp, seg=seg,
                                                     mirror=True),
            "fused mirror, config-2 recipe n=4096": panel2.build_panel2_plan(
                fused2, d2[5], seg=seg, mirror=True),
            "wide mirror": panel2.build_panel2_plan(wide, (nw, nw), seg=seg,
                                                    mirror=True),
            "past ncols": panel2.build_panel2_plan(wrap, (64, 1010), seg=seg),
        }
        require(plans["fused mirror"].mirror, "the fused v2 plan must mirror")
        require(plans["past ncols"].NC * seg > 1010,
                "the last segment must run past ncols")
        modes = set()
        for label, plan in plans.items():
            dev = panel2_spmv.panel2_device_arrays(plan, DEV)
            x = torch.randn(plan.ncols, generator=gen).to(DEV)
            span = split_span(plan)
            blocks_ = None if span is None else -(-plan.S * plan.TS // span)
            print(f"  B10 seg {seg} {label}: {describe(plan)}; "
                  f"{b10_launch_text(plan)}; ranges splitting a row chunk: "
                  f"{'none' if span is None else f'{span} tiles, {blocks_} blocks'}")
            if span is not None and blocks_ < plan.S:
                fewer.append((seg, label))
            modes.add(check_b10(f"seg {seg} {label}", plan, dev, x, errs,
                                span))
        require(modes == set(panel_spmv.PANEL_MODES),
                f"seg {seg}: phase 1 must drive every B10 mode, drove "
                f"{sorted(modes)}")
    require(fewer, "no v2 plan ran with fewer blocks than slabs")
    return errs


# -- phase 2 -------------------------------------------------------------------

def phase2():
    print("phase 2: flagship operator 4096^2, 200 x 64x64 f32, r=64")
    # the JAX package's flagship recipe (seed 7): structure, values, then X
    A, rng = contiguous_operator(4096, 200, 64, seed=7, value_seed=None,
                                 device=DEV)
    Xn = rng.standard_normal((4096, 64)).astype(np.float32)
    xn = rng.standard_normal(4096).astype(np.float32)
    yn = rng.standard_normal(4096).astype(np.float32)
    X, x, y = (torch.from_numpy(a).to(DEV) for a in (Xn, xn, yn))
    S = bt.to_scipy(A).astype(np.float64)
    print(f"  {A}")
    # a constructor called without device= builds on the card
    A_default = bt.from_reference(A)
    require(A_default.device.type == "cuda",
            f"a constructor without device= built on {A_default.device}")
    print(f"  without device=: {A_default.device}")
    plan, dev = A._patch_for()
    require(patch_wins(plan, [(A.layout, 1)], 64), "flagship r=64 must take the patch route")
    require(stream_kernel(A) == stream_kernel(A, True) == "B1",
            "the flagship's r = 1 products stay on the bucket route (the "
            "JAX decision)")

    # kernels against their plain versions at the flagship's shapes
    errs = {"B1": 0.0, "B2": 0.0, "B2 transpose": 0.0}
    for hb, (v, _ri, _ci, rc, cc) in zip(A.layout.buckets, A._buckets):
        for tr in (False, True):
            got = fused_spmm.chunked_block_apply(v, rc, cc, hb.chunk, x, 4096, transpose=tr)
            ref = fused_spmm.chunked_block_apply_plain(v, rc, cc, hb.chunk, x, 4096, transpose=tr)
            torch.cuda.synchronize()
            errs["B1"] = max(errs["B1"], rel_check(
                f"B1 bucket {hb.mp}x{hb.kp} nb={hb.nblocks} "
                f"{'transpose' if tr else 'forward'} r=1", got, ref, TOL[torch.float32]))
    for vals, cc, rs, _mk in dev:
        for tr in (False, True):
            got = patch_engine.bucket_spmm(vals, cc, rs, X, 4096, transpose=tr)
            ref = patch_engine.bucket_spmm_plain(vals, cc, rs, X, 4096, transpose=tr)
            torch.cuda.synchronize()
            key = "B2 transpose" if tr else "B2"
            errs[key] = max(errs[key], rel_check(
                f"B2 {'transpose' if tr else 'forward'} r=64", got, ref, TOL[torch.float32]))

    # the main path, counted
    products = [
        ("A @ X", lambda: A @ X, S @ Xn.astype(np.float64), "B2"),
        ("A @ x", lambda: A @ x, S @ xn.astype(np.float64), "B1"),
        ("A.T @ x", lambda: A.T @ x, S.T @ xn.astype(np.float64), "B1"),
        ("A.H @ X", lambda: A.H @ X, S.T @ Xn.astype(np.float64),
         "B2 transpose"),
        ("A.axpby(x, y, 2.0, 0.5)", lambda: A.axpby(x, y, 2.0, 0.5),
         2.0 * (S @ xn.astype(np.float64)) + 0.5 * yn.astype(np.float64), "B1"),
        ("(A @ A) @ x", lambda: (A @ A) @ x,
         S @ (S @ xn.astype(np.float64)), "B1"),
    ]
    reset_counts()
    outs, per = [], {}
    for name, fn, _ref, kernel in products:
        before = counts()
        outs.append(fn())
        per[name] = grown_since(before)
        require(per[name][kernel] > 0, f"{name}: kernel {kernel} was not launched")
    torch.cuda.synchronize()
    launches = counts()
    launches["B1 rows"] = fused_spmm.ROW_LAUNCHES  # also under "B1"
    print(f"  main-path launches: {launches}")
    # B2's forward and its transpose each run the prologue first
    require(per["A @ X"]["B2 prologue"] == per["A @ X"]["B2"]
            and per["A @ X"]["B2 transpose"] == 0
            and per["A.H @ X"]["B2 prologue"] == per["A.H @ X"]["B2 transpose"]
            and per["A.H @ X"]["B2"] == 0,
            f"B2 launches: {per['A @ X']}, {per['A.H @ X']}")
    launches["B2 forward"] = per["A @ X"]["B2"]
    # the r = 1 products: one B1 launch per application of A
    for name, tr, k in (("A @ x", False, 1), ("A.T @ x", True, 1),
                        ("A.axpby(x, y, 2.0, 0.5)", False, 1),
                        ("(A @ A) @ x", False, 2)):
        require_counts(name, per[name], {key: k * v for key, v in
                                         bucket_want(A, tr).items()})
    for (name, _fn, ref, _k), out in zip(products, outs):
        rel_check(f"{name} vs float64 scipy", out, ref, TOL[torch.float32])
    require(launches["B1"] > 0 and launches["B2"] > 0
            and launches["B2 transpose"] > 0,
            f"main path skipped a kernel: {launches}")

    # gradients: the backward passes run each kernel in the other mode
    Wn = rng.standard_normal((4096, 64)).astype(np.float32)
    W = torch.from_numpy(Wn).to(DEV)
    for name, r in (("d(W . A @ X)/dX", 64), ("d(w . A @ x)/dx", 1)):
        before = counts()
        Xg = (X if r > 1 else x).clone().requires_grad_()
        Wr = W if r > 1 else W[:, 0]
        (Wr * (A @ Xg)).sum().backward()
        ref = S.T @ (Wn if r > 1 else Wn[:, 0]).astype(np.float64)
        rel_check(name, Xg.grad, ref, TOL[torch.float32])
        grown = {k: counts()[k] - before[k] for k in before}
        # the forward and its dX: B2 then B2's transpose; B1 twice at r = 1
        require(grown["B2"] >= 1 and grown["B2 transpose"] >= 1 if r > 1
                else grown["B1"] >= 2,
                f"{name}: backward did not run the kernel ({grown})")
    return errs, launches


# -- phase 3 -------------------------------------------------------------------

def describe(plan) -> str:
    if plan is None:
        return "none"
    kind = "mirror" if plan.mirror else "plain"
    if isinstance(plan, panel2.Panel2Plan):
        extra = f", CW {plan.CW}, RW {plan.RW}, v2 seg {plan.seg}"
    elif hasattr(plan, "CW"):
        extra = (f", CW {plan.CW}, RW {plan.RW}, grids {plan.grids_used}, "
                 f"{plan.nt} live tiles ({plan.nt * 4096 / 1e6:.1f} MB)")
    else:
        extra = ""
    return (f"{plan.S} slabs x {plan.TS} tiles{extra}, {kind}, "
            f"{plan.tile_bytes / 1e6:.1f} MB + {plan.aux_bytes / 1e6:.2f} MB "
            f"aux (as the JAX package counts it)")


def stream_setup(op, transpose=False) -> dict:
    """Build ``op``'s host panel and slab plans and stage the chosen one,
    timed (the operator does this at its first f32 r = 1 product)."""
    t0 = time.perf_counter()
    pplan = op._panel_for(transpose)
    t1 = time.perf_counter()
    splan = op._strip_for(transpose)
    t2 = time.perf_counter()
    choice = op._stream_entry(transpose)[0]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"  panel plan: {describe(pplan)}, {t1 - t0:.2f} s on the host")
    print(f"  slab plan: {describe(splan)}, {t2 - t1:.2f} s on the host")
    print(f"  stream route decision: {choice} ({stream_kernel(op, transpose)}"
          f"); staging {t3 - t2:.2f} s")
    plan = op._stream_entry(transpose)[1]
    if isinstance(plan, PanelPlan):
        print(f"  plan the r = 1 product reads: {describe(plan)}; "
              f"{b5_launch_text(plan)}")
    return {"panel_s": t1 - t0, "strip_s": t2 - t1, "stage_s": t3 - t2}


def stream_bytes(op, transpose=False) -> int:
    """Bytes a stream kernel reads per product: values and staged ids."""
    dev = op._stream_entry(transpose)[2]
    return sum(t.numel() * t.element_size() for t in dev if t is not None)


def require_counts(name, got: dict, want: dict) -> None:
    sub = {k: got[k] for k in want}
    require(sub == want, f"{name}: launches {sub}, expected {want}")


def b2_real(A, X, bounds, card) -> dict:
    """Phase 3's SpMM through B2 beside the default ("highest") operator:
    at precision=None (a second operator built with it), A.T @ X at both
    tiers, each checked against the float64 plain route and timed eager and
    from a CUDA graph; then, eager and from a CUDA graph, the prologue
    alone, the bucket's forward (prologue included), B4's forward instance
    at P = 1 on the same plan, and the transposed kernel alone (its grid,
    and the X^T bytes its blocks load, its output adds and its X^T scratch
    as the plan gives them, printed beside it); and the host time per
    call."""
    n, r = X.shape
    An, _ = contiguous_operator(8192, 2000, 128, seed=7, value_seed=7 + 7777,
                                device=DEV, precision=None)
    plan, dev = A._patch_for()
    vals, cc, rs, _mk = dev[0]
    b = plan.buckets[0]
    live = int((b.col_chunk < -(-n // CC)).sum())
    print(f"  B2 plan: {b.nb} slots of {b.MP}x{b.KP}, "
          f"{b.col_chunk.size - live} of {b.col_chunk.size} chunk slots "
          f"sentinel")
    before = counts()
    Yn, Yt, Ytn = An @ X, A.T @ X, An.T @ X
    torch.cuda.synchronize()
    require_counts("A @ X at None, A.T @ X at both tiers", grown_since(before),
                   {"B2": 1, "B2 transpose": 2, "B2 prologue": 3, "B4": 0,
                    "B1": 0})
    ref_t = plain_route(A, X, transpose=True, dtype=torch.float64)
    out = {
        "none_err": rel_check("SpMM r=128 precision=None vs float64 plain",
                              Yn, plain_route(A, X, dtype=torch.float64),
                              TOL_TF32),
        "transpose_err": rel_check("A.T @ X r=128 vs float64 plain", Yt,
                                   ref_t, TOL32),
        "transpose_none_err": rel_check(
            "A.T @ X r=128 precision=None vs float64 plain", Ytn, ref_t,
            TOL_TF32)}
    del Yn, Yt, Ytn, ref_t
    routes = {("A @ X", "highest"): lambda: A @ X,
              ("A @ X", None): lambda: An @ X,
              ("A.T @ X", "highest"): lambda: A.T @ X,
              ("A.T @ X", None): lambda: An.T @ X}
    eager = {k: [] for k in routes}
    for k in list(routes) + list(routes)[::-1]:
        eager[k].append(median_ms(routes[k]))
    for (name, prec), fn in routes.items():
        graph = graph_ms(fn)
        bnd = bounds["SpMM r=128" + (" None" if prec is None else "")]
        out[(name, prec)] = (min(eager[(name, prec)]), graph)
        print(f"  B2 {name} precision={prec}: eager "
              f"{eager[(name, prec)][0]:.4f} / {eager[(name, prec)][1]:.4f} "
              f"ms, graph {graph:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}): "
              f"{100 * bnd[0] / graph:.1f}% of the bound [{card}]")
    for prec in ("highest", None):
        tier = patch_engine.precision_tier(prec)
        parts = {
            "prologue": lambda t=tier: patch_engine.patch_xt(X, t)[0],
            "forward": lambda p=prec: patch_engine.bucket_spmm(
                vals, cc, rs, X, n, precision=p),
            "B4 P=1": lambda p=prec: batched_spmm.batched_spmm(
                vals[None], cc, rs, X[None], n, precision=p),
        }
        hi, lo = patch_engine.patch_xt(X[None], tier)
        parts["transposed kernel"] = (
            lambda t=tier, hi=hi, lo=lo: patch_engine.patch_tr(
                vals[None], cc, rs, hi, lo, n, n, t))
        for name, fn in parts.items():
            out[(name, prec)] = (median_ms(fn), graph_ms(fn))
        pro = bounds["prologue" + (" None" if prec is None else "")]
        print(f"  B2 parts, precision={prec} (eager / graph ms): "
              + ", ".join(f"{name} {out[(name, prec)][0]:.4f} / "
                          f"{out[(name, prec)][1]:.4f}" for name in parts)
              + f"; prologue bound {pro[0]:.4f} ms ({pro[1]}) [{card}]")
        out[("transpose grid", prec)] = tr = transpose_traffic(
            b, n, r, tier, hi.shape[-1])
        print(f"  B2 transpose grid (modelled from the plan), precision={prec}: "
              f"static split of each "
              f"slot's live chunk pairs into groups of {tr['group']} 64-row "
              f"tiles, TR = {tr['TR']}: {tr['blocks']} blocks on "
              f"{tr['sms']} SMs ({tr['busy_blocks']} with work); X^T loaded "
              f"{tr['xt_bytes'] / 1e6:.1f} MB, adds into Y "
              f"{tr['add_bytes'] / 1e6:.1f} MB (TMA reduce-add), X^T scratch "
              f"{tr['scratch_bytes'] / 1e6:.2f} MB [{card}]")
    out["host_us"] = {
        "A @ X": host_us(lambda: A @ X),
        "bucket_spmm": host_us(
            lambda: patch_engine.bucket_spmm(vals, cc, rs, X, n)),
        "prologue": host_us(lambda: patch_engine.patch_xt(X, 1))}
    print("  B2 host time per call (enqueue only): " + ", ".join(
        f"{k} {v:.1f} us" for k, v in out["host_us"].items()))
    return out


def transpose_traffic(b, n: int, r: int, tier: int, ld: int) -> dict:
    """B2's transposed launch on patch bucket ``b`` (host plan) for X [n, r]
    into n rows: the grid ``tr_geometry`` picks, the blocks with work, the
    X^T bytes those blocks load (their whole window, hi and lo at tier 1),
    the bytes added into Y (one add per live chunk row and column of every
    slot; TMA reduce-adds in the L2 where r % 4 == 0) and the prologue's
    X^T scratch."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    TR, group, blocks = patch_engine.tr_geometry(1, b.nb, b.MP, b.KP, r,
                                                 tier, sms)
    live = (b.col_chunk < -(-n // CC)).sum(axis=1)   # per slot
    tiles = -(-live // 2)                              # 64-row tiles
    busy = int((-(-tiles // group)).sum()) * -(-r // TR)
    return {"TR": TR, "group": group, "blocks": blocks, "sms": sms,
            "busy_blocks": busy,
            "xt_bytes": busy * -(-b.MP // 32) * TR * 128 * (1 + tier),
            "add_bytes": int(live.sum()) * CC * r * 4,
            "scratch_bytes": r * ld * 4 * (1 + tier)}


def host_us(fn, reps: int = 200) -> float:
    """Host time per call in µs: the calls only enqueue, and the card is
    left to catch up after the clock stops."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return dt


def phase3(card: str):
    print("phase 3: real size n=8192, 2000 x 128x128 f32 (config-1 recipe)")
    A, vrng = contiguous_operator(8192, 2000, 128, seed=7, value_seed=7 + 7777,
                                  device=DEV)
    value_bytes = sum(int(b.values.nbytes) for b in A.layout.buckets)
    print(f"  {A}; {value_bytes / 1e6:.1f} MB of bucket values")
    setup = stream_setup(A)
    require(stream_kernel(A) == "B5",
            "the real-size SpMV takes the panel route (the JAX decision)")
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(8192, generator=gen).to(DEV)
    X = torch.randn((8192, 128), generator=gen).to(DEV)
    reset_counts()
    y = A @ x
    Y = A @ X
    torch.cuda.synchronize()
    launched = counts()
    print(f"  launches: SpMV + SpMM r=128 -> {launched}")
    require_counts("SpMV + SpMM r=128", launched, stream_want(A))
    require(launched["B2"] > 0, f"SpMM r=128 skipped B2: {launched}")
    rel_check("SpMV (B5) vs float64 plain", y,
              plain_route(A, x, dtype=torch.float64), TOL[torch.float32])
    rel_check("SpMM r=128 vs float64 plain", Y,
              plain_route(A, X, dtype=torch.float64), TOL[torch.float32])
    # the bucket route, driven explicitly: one B1 launch over the chunked
    # buckets, and one for its backward
    bucket_launched, _ = check_bucket_route("bucket-route SpMV (B1)", A, x)
    plan = A._patch_for()[0]
    splan = A._stream_entry(False)[1]
    csr = csr_on_card([A])
    nnz = A.nnz
    library = {
        "SpMV": library_ms("SpMV, torch.mv on the CSR matrix",
                           lambda: torch.mv(csr, x), y, card),
        "SpMM r=128": library_ms("SpMM r=128, CSR matrix @ X",
                                 lambda: csr @ X, Y, card)}
    del csr
    csr_t = csr_on_card([A], transpose=True)
    library["SpMM r=128 transpose"] = library_ms(
        "A.T @ X r=128, transposed CSR matrix @ X", lambda: csr_t @ X,
        A.T @ X, card)
    del csr_t
    spmm_bytes, spmm_flops = nnz * 4 + 2 * 8192 * 128 * 4, 2 * nnz * 128
    bounds = {"SpMV": bound(nnz * 4 + 2 * 8192 * 4, 2 * nnz),
              "SpMM r=128": bound(spmm_bytes, spmm_flops),
              "SpMM r=128 None": bound(spmm_bytes, spmm_flops, None),
              # X read once, X^T written once (hi; hi and lo at tier 1)
              "prologue": bound(3 * 8192 * 128 * 4, 0),
              "prologue None": bound(2 * 8192 * 128 * 4, 0)}
    b2 = b2_real(A, X, bounds, card)
    return {
        "library": library, "bound": bounds, "B2": b2,
        "SpMV": time_routes(
            "SpMV, stream route (B5)", lambda: A @ x,
            lambda: plain_route(A, x), stream_bytes(A),
            2 * splan.tile_bytes // 4, card),
        "SpMV bucket": time_routes(
            "SpMV, bucket route (B1)", lambda: bucket_route(A, x),
            lambda: plain_buckets(A.layout, A._buckets, x, 8192,
                                  torch.float32),
            value_bytes, 2 * value_bytes // 4, card),
        "SpMM r=128": time_routes(
            "SpMM r=128", lambda: A @ X, lambda: plain_route(A, X),
            plan.value_bytes, 2 * plan.value_bytes // 4 * 128, card),
        "SpMM r=128 transpose plain": plain_times(
            "A.T @ X r=128", lambda: plain_route(A, X, transpose=True), card),
        "prologue plain": plain_times(
            "B2 prologue (tier 1)",
            lambda: patch_engine.patch_xt_plain(X, 1)[0], card),
        "setup": setup, "launches": launched["B5"], "op": A,
        "bucket launches": bucket_launched,
        "r1 bodies": r1_compare("config 1 A @ x, bucket route",
                                op_tables(A), x, card),
    }


def check_bucket_route(name, op, x, transpose=False) -> dict:
    """One bucket-route product of ``op`` (driven explicitly) and then the
    product with its backward, each with exact launch counts
    (``bucket_want``), against the float64 plain route; returns the
    product's launches and its error."""
    drive = bucket_route_sym if hasattr(op, "_dlayout") else bucket_route
    before = counts()
    y = drive(op, x, transpose)
    torch.cuda.synchronize()
    got = grown_since(before)
    print(f"  {name}: launches "
          f"{ {k: v for k, v in got.items() if v} }")
    require_counts(name, got, dict(bucket_want(op, transpose), B5=0, B8=0))
    err = rel_check(f"{name} vs float64 plain", y,
                    float64_reference(op, x, transpose), TOL32)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(31),
                    dtype=y.dtype).to(DEV)
    before = counts()
    xg = x.clone().requires_grad_()
    (w * drive(op, xg, transpose)).sum().backward()
    torch.cuda.synchronize()
    require_counts(f"{name} and its backward", grown_since(before),
                   bucket_want(op, transpose, backward=True))
    rel_check(f"d(w . {name})/dx vs float64 plain", xg.grad,
              float64_reference(op, w, not transpose), TOL32)
    return got, err


def plain_times(label, fn, card) -> tuple:
    """(eager, graph) ms of a plain version."""
    out = (median_ms(fn), graph_ms(fn))
    print(f"  {label}, plain version: eager {out[0]:.4f} ms, graph "
          f"{out[1]:.4f} ms [{card}]")
    return out


# -- phase 4 -------------------------------------------------------------------

def value_bytes_of(*layouts) -> int:
    return sum(int(b.values.nbytes) for lay in layouts for b in lay.buckets)


def n_chunked(*layouts) -> int:
    return sum(b.chunk > 1 for lay in layouts for b in lay.buckets)


def phase4(card: str):
    print("phase 4: symmetric flagship 4096^2, 48 diagonal + 160 off-diagonal "
          "f32 blocks (config-2 recipe), r=64")
    d, di, o, ri, ci, shape = random_symmetric(
        8, n=4096, ngroups=48, noffdiag=160, dtype=np.float32, contiguous=True)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device=DEV)
    Ssc = bt.to_scipy(S).astype(np.float64)
    require(abs(Ssc - Ssc.T).max() > 1e-3, "fixture must have S^T != S")
    print(f"  {S}; {value_bytes_of(S._dlayout, S._olayout) / 1e6:.1f} MB of "
          f"bucket values")
    rng = np.random.default_rng(9)
    Xn = rng.standard_normal((4096, 64)).astype(np.float32)
    xn = rng.standard_normal(4096).astype(np.float32)
    yn = rng.standard_normal(4096).astype(np.float32)
    X, x, y = (torch.from_numpy(a).to(DEV) for a in (Xn, xn, yn))
    reads = [(S._dlayout, 1), (S._olayout, 2)]
    for tm in (False, True):
        require(patch_wins(S._patch_for(tm)[0], reads, 64),
                "symmetric flagship r=64 must take the patch route")

    # kernels against their plain versions at the flagship's shapes
    errs = {"B1": 0.0, "B3": 0.0}
    for hb, (v, _ri, _ci, rc, cc) in zip(S._olayout.buckets, S._obuckets):
        if hb.chunk > 1:
            got = fused_spmm.chunked_block_apply(v, rc, cc, hb.chunk, x, 4096,
                                                 symmetric=True)
            ref = fused_spmm.chunked_block_apply_plain(v, rc, cc, hb.chunk, x,
                                                       4096, symmetric=True)
            torch.cuda.synchronize()
            errs["B1"] = max(errs["B1"], rel_check(
                f"B1 symmetric bucket {hb.mp}x{hb.kp} nb={hb.nblocks} "
                f"C={hb.chunk} r=1", got, ref, TOL[torch.float32]))
    for tm in (False, True):
        vals, cc, rs, mk = S._patch_for(tm)[1][0]
        for adj in (False, True):
            got = patch_engine.bucket_spmm_sym(vals, cc, rs, mk, X, adjoint=adj)
            ref = patch_engine.bucket_spmm_sym_plain(vals, cc, rs, mk, X,
                                                     adjoint=adj)
            torch.cuda.synchronize()
            errs["B3"] = max(errs["B3"], rel_check(
                f"B3 {'adjoint' if adj else 'symmetric'} transpose_main={tm} "
                f"r=64", got, ref, TOL[torch.float32]))

    # the symmetric main path, counted: r > 1 through B3, r = 1 through
    # the stream route (the fused mirror panel plan, one B5 launch)
    setup = stream_setup(S)
    stream_setup(S, transpose=True)
    require(stream_kernel(S) == stream_kernel(S, True) == "B5" and
            S._stream_entry(False)[1].mirror,
            "the symmetric flagship's r = 1 products take the fused mirror "
            "panel plan (the JAX decision)")
    x64, X64, y64 = (a.astype(np.float64) for a in (xn, Xn, yn))
    # (name, product, reference, kernel, applications of S, transpose)
    products = [
        ("S @ X", lambda: S @ X, Ssc @ X64, "B3", 1, False),
        ("S @ x", lambda: S @ x, Ssc @ x64, "B5", 1, False),
        ("S.T @ x", lambda: S.T @ x, Ssc.T @ x64, "B5", 1, True),
        ("S.T @ X", lambda: S.T @ X, Ssc.T @ X64, "B3", 1, True),
        ("S.H @ X", lambda: S.H @ X, Ssc.T @ X64, "B3", 1, True),
        ("S.axpby(x, y, 2.0, 0.5)", lambda: S.axpby(x, y, 2.0, 0.5),
         2.0 * (Ssc @ x64) + 0.5 * y64, "B5", 1, False),
        ("(S @ S) @ x", lambda: (S @ S) @ x, Ssc @ (Ssc @ x64), "B5", 2,
         False),
    ]
    reset_counts()
    outs = []
    for name, fn, _ref, kernel, k, tr in products:
        before = counts()
        outs.append(fn())
        grown = grown_since(before)
        require(grown[kernel] > 0, f"{name}: kernel {kernel} was not launched")
        if kernel == "B5":
            require_counts(name, grown, stream_want(S, tr, k))
    torch.cuda.synchronize()
    launches = counts()
    print(f"  main-path launches: {launches}")
    for (name, _fn, ref, *_), out in zip(products, outs):
        rel_check(f"{name} vs float64 scipy", out, ref, TOL[torch.float32])

    # the bucket route, driven explicitly: per layout one B1 launch over
    # its chunked buckets, the off-diagonal's in B1's symmetric mode
    require(n_chunked(S._olayout) > 0, "no chunked off-diagonal bucket")
    for tr in (False, True):
        name = f"bucket-route S{'.T' if tr else ''} @ x (B1 symmetric)"
        check_bucket_route(name, S, x, tr)
        rel_check(f"{name} vs float64 scipy", bucket_route_sym(S, x, tr),
                  (Ssc.T if tr else Ssc) @ x64, TOL[torch.float32])

    # gradients: B3's backward runs its adjoint mode; B5's backward is the
    # plain version's autograd on the same plan
    Wn = rng.standard_normal((4096, 64)).astype(np.float32)
    W = torch.from_numpy(Wn).to(DEV)
    for name, r in (("d(W . S @ X)/dX", 64), ("d(w . S @ x)/dx", 1)):
        before = counts()
        Xg = (X if r > 1 else x).clone().requires_grad_()
        Wr = W if r > 1 else W[:, 0]
        (Wr * (S @ Xg)).sum().backward()
        ref = Ssc.T @ (Wn if r > 1 else Wn[:, 0]).astype(np.float64)
        rel_check(name, Xg.grad, ref, TOL[torch.float32])
        grown = grown_since(before)
        require(grown["B3"] >= 2 if r > 1 else grown["B5 mirror"] == 1,
                f"{name}: the product did not run the kernel ({grown})")
    launches["setup"] = setup
    launches["scattered"] = scattered_main_path(card)
    mplan = S._stream_entry(False)[1]
    vbytes = value_bytes_of(S._dlayout, S._olayout)
    launches["times"] = {
        "SpMV": time_routes(
            "symmetric flagship SpMV, stream route (B5 mirror)",
            lambda: S @ x, lambda: plain_route_sym(S, x), stream_bytes(S),
            4 * mplan.tile_bytes // 4, card),
        "SpMV bucket": time_routes(
            "symmetric flagship SpMV, bucket route (B1 symmetric)",
            lambda: bucket_route_sym(S, x), lambda: plain_buckets_sym(S, x),
            vbytes, 2 * vbytes // 4, card),
    }
    return errs, launches


def old_colored_chain(S, x):
    """S's bucket route as it ran before the colored rounds: per layout one
    B1 launch, and a colored pass's element buckets through
    ``bucket_apply``'s per-bucket chain (a gather per bucket, B9's one-call
    gather at f32 r = 1, an einsum each, a concatenation, one index and one
    add per color); an uncolored pass's through the element pass."""
    y = x.new_zeros((S.shape[0],) + tuple(x.shape[1:]))
    for (lay, colors, n, tr, sym, _a, _k), bk in zip(
            passes_of(S), (S._dbuckets, S._obuckets)):
        tabs = bucket_tables(bk, lay)
        if tabs["chunked"] is not None:
            y = fused_spmm.multi_block_apply(tabs["chunked"], x, out=y,
                                             transpose=tr, symmetric=sym)
        if tabs["element"] is None:
            continue
        plan = pass_plan(lay, colors, n, tr, sym)
        if plan is None:
            y = mask_select.element_apply(tabs["element"], x, out=y,
                                          transpose=tr, symmetric=sym)
        else:
            y = y + bucket_apply([bk[i][:3] for i in elem_ids(lay)], n, x,
                                 transpose=tr, symmetric=sym,
                                 colored_plan=plan, mask_gs=True)
    return y


def colored_route_plain(S, x):
    """S's colored bucket route with every kernel replaced by its plain
    version (B1's, and the colored route's or the element pass's)."""
    y = x.new_zeros((S.shape[0],) + tuple(x.shape[1:]))
    for (lay, colors, n, tr, sym, _a, _k), bk in zip(
            passes_of(S), (S._dbuckets, S._obuckets)):
        tabs = bucket_tables(bk, lay)
        if tabs["chunked"] is not None:
            y = fused_spmm.multi_block_apply_plain(
                tabs["chunked"], x, out=y, transpose=tr, symmetric=sym)
        if tabs["element"] is None:
            continue
        plan = pass_plan(lay, colors, n, tr, sym)
        if plan is None:
            y = mask_select.element_apply_plain(tabs["element"], x, out=y,
                                                transpose=tr, symmetric=sym)
        else:
            y = mask_select.colored_apply_plain(tabs["element"], plan, x,
                                                out=y, transpose=tr,
                                                symmetric=sym)
    return y


def rounds_alone(label, S, card) -> dict:
    """The off-diagonal pass's rounds launch alone (r = 1, on the scratch of
    its products) against the plain rounds (the same bits expected), two
    launches bit-equal, timed beside its plain version, its bound (tables,
    the scratch rows they name, y read and written) and one PyTorch call
    computing the same sums (the 0/1 gather matrix of the tables in CSR,
    times the scratch)."""
    lay, colors, n = S._olayout, S.fusedcolors(), S.shape[0]
    plan = pass_plan(lay, colors, n, False, True)
    require(plan is not None, f"{label}: the off-diagonal pass has no plan")
    tables, total = plan
    etab = bucket_tables(S._obuckets, lay)["element"]
    x = torch.randn(n, generator=torch.Generator().manual_seed(41)).to(DEV)
    P = mask_select.colored_products_plain(etab, x, symmetric=True)
    ref = mask_select.colored_rounds_plain(plan, P, out=x.new_zeros(n))
    kern = lambda: mask_select.colored_rounds(plan, P, x.new_zeros(n))
    plain = lambda: mask_select.colored_rounds_plain(plan, P,
                                                     out=x.new_zeros(n))
    got, again = kern(), kern()
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"{label}: two rounds launches differ")
    out = {"colors": int(tables.shape[0]), "total": int(total),
           "bit_equal_plain": bool(torch.equal(got, ref)),
           "err": rel_check(f"{label}: rounds vs the plain rounds", got, ref,
                            TOL32)}
    p1, k1, k2, p2 = (median_ms(plain), median_ms(kern), median_ms(kern),
                      median_ms(plain))
    live = tables < total
    nlive = int(live.sum())
    nbytes = tables.numel() * 4 + nlive * 4 + 2 * n * 4
    out.update(ms=min(k1, k2), plain_ms=min(p1, p2), graph_ms=graph_ms(kern),
               plain_graph_ms=graph_ms(plain), live=nlive,
               bound=bound(nbytes, nlive))
    rows = torch.arange(n, device=DEV).expand_as(tables)[live]
    gmat = torch.sparse_coo_tensor(
        torch.stack([rows, tables[live].long()]),
        torch.ones(nlive, device=DEV), (n, total)).coalesce().to_sparse_csr()
    out["library"] = library_ms(f"{label}: rounds, the gather matrix in CSR "
                                f"@ the scratch", lambda: torch.mv(
                                    gmat, P[:, 0]), got, card)
    print(f"  {label}: rounds alone, {out['colors']} colors, {n} rows, "
          f"{nlive} live table entries: eager {out['ms']:.4f} ms, graph "
          f"{out['graph_ms']:.4f} ms, bit-equal to the plain rounds "
          f"{out['bit_equal_plain']}; plain {out['plain_ms']:.4f} / "
          f"{out['plain_graph_ms']:.4f} ms; bound "
          f"{out['bound'][0] * 1e3:.3f} us ({out['bound'][1]}) [{card}]")
    return out


def products_matrix(etab, n: int) -> torch.Tensor:
    """The symmetric pass's products as one sparse matrix ``M [total, n]``
    in CSR on the card, ``P = M @ x`` in the scratch's flat order: forward
    row ``b * mp + i`` of a bucket holds ``V_b[i, :]`` at its column
    indices, mirror row ``b * kp + k`` (after every forward part) holds
    ``V_b[:, k]`` at its row indices; entries in a sentinel row or column
    (index >= n) left out."""
    fwd = sum(v.shape[0] * v.shape[1] for v in etab.values)
    rows, cols, vals, fbase, mbase = [], [], [], 0, fwd
    for v, ridx, cidx, _chunk in etab.buckets:
        nb, mp, kp = v.shape
        ri = ridx.long()[:, :, None].expand(nb, mp, kp)
        ci = cidx.long()[:, None, :].expand(nb, mp, kp)
        keep = (ri < n) & (ci < n)
        frow = fbase + torch.arange(nb * mp, device=DEV).view(nb, mp, 1)
        mrow = mbase + torch.arange(nb * kp, device=DEV).view(nb, 1, kp)
        for prow, col in ((frow, ci), (mrow, ri)):
            rows.append(prow.expand(nb, mp, kp)[keep])
            cols.append(col[keep])
            vals.append(v.float()[keep])
        fbase, mbase = fbase + nb * mp, mbase + nb * kp
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (mbase, n)).coalesce().to_sparse_csr()


def products_alone(label, S, card) -> dict:
    """The off-diagonal (symmetric) pass's products at r = 1 alone: the
    one-read kernel (one launch) against the tile core's two launches and
    the plain version on the same scratch layout, each timed eager and
    from a CUDA graph, beside its bound (the bucket values as stored, x and
    the scratch once each; 4 operations per value) and one PyTorch call
    computing the same scratch (``products_matrix`` in CSR times x)."""
    lay, n = S._olayout, S.shape[0]
    etab = bucket_tables(S._obuckets, lay)["element"]
    x = torch.randn(n, generator=torch.Generator().manual_seed(42)).to(DEV)
    total = sum(v.shape[0] * (v.shape[1] + v.shape[2]) for v in etab.values)
    xm = x[:, None]

    def scratch(body):
        P = torch.empty((total, 1), device=DEV)
        if body == "one-read":
            mask_select._products_r1(etab, xm, P, 0, False, True)
        else:
            for tr, base in mask_select._scratch_parts(etab, False, True):
                mask_select._products_launch(
                    etab, mask_select.scratch_offsets(etab, tr, base), xm, P,
                    int(tr), tr)
        return P

    plain = lambda: mask_select.colored_products_plain(etab, x,
                                                       symmetric=True)
    ref = plain()
    out = {"err": max(rel_check(f"{label}: {body} products vs plain",
                                scratch(body), ref, TOL32)
                      for body in ("one-read", "tile"))}
    one, again = scratch("one-read"), scratch("one-read")
    torch.cuda.synchronize()
    require(torch.equal(one, again), f"{label}: two one-read products "
            f"launches differ")
    for body in ("one-read", "tile", "one-read", "tile"):
        fn = lambda body=body: scratch(body)
        out[f"{body} ms"] = min(out.get(f"{body} ms", 1e9), median_ms(fn))
        out[f"{body} graph"] = min(out.get(f"{body} graph", 1e9),
                                   graph_ms(fn))
    out["plain ms"], out["plain graph"] = median_ms(plain), graph_ms(plain)
    vbytes = sum(v.numel() * v.element_size() for v in etab.values)
    out["bound"] = bound(vbytes + n * 4 + total * 4,
                         4 * sum(v.numel() for v in etab.values))
    mat = products_matrix(etab, n)
    out["library"] = library_ms(f"{label}: symmetric products, their "
                                f"matrix in CSR @ x", lambda: torch.mv(mat, x),
                                one[:, 0], card)
    del mat
    print(f"  {label}: symmetric products pass alone, r = 1 ({total} "
          f"scratch rows, {vbytes / 1e6:.1f} MB of bucket values): one-read "
          f"{out['one-read graph']:.4f} ms graph / {out['one-read ms']:.4f} "
          f"eager, tile core (two launches) {out['tile graph']:.4f} / "
          f"{out['tile ms']:.4f}, plain {out['plain graph']:.4f} / "
          f"{out['plain ms']:.4f}; bound {out['bound'][0]:.4f} ms "
          f"({out['bound'][1]}) [{card}]")
    return out


def colored_cell(label, Sc, Ss, Ssc, card) -> dict:
    """A colored cell's products at r = 1 and r = 64: the new route (the
    bucket route of the colored operator: per colored pass a products pass
    and one rounds launch) with exact launches and against float64 scipy,
    timed eager and from a CUDA graph beside its plain version, the serial
    route on the same operands (element passes), the old chain
    (``old_colored_chain``) and the expanded CSR library call."""
    n = Sc.shape[0]
    csr = csr_on_card([Sc])
    out = {}
    for r in (1, 64):
        g = torch.Generator().manual_seed(40 + r)
        X = torch.randn((n, r) if r > 1 else n, generator=g).to(DEV)
        X64 = X.double().cpu().numpy()
        routes = {"colored": lambda: bucket_route_sym(Sc, X),
                  "serial": lambda: bucket_route_sym(Ss, X),
                  "old chain": lambda: old_colored_chain(Sc, X),
                  "plain": lambda: colored_route_plain(Sc, X)}

        reset_counts()
        y = routes["colored"]()
        torch.cuda.synchronize()
        got = counts()
        require_counts(f"{label} r={r} colored route", got,
                       bucket_want(Sc, r=r))
        res = {"launches": {k: v for k, v in got.items() if v},
               "err": rel_check(f"{label} r={r} colored route vs float64 "
                                f"scipy", y, Ssc @ X64, TOL32)}
        rel_check(f"{label} r={r} old chain vs the colored route",
                  routes["old chain"](), y, TOL32)
        rel_check(f"{label} r={r} serial route vs the colored route",
                  routes["serial"](), y, TOL32)
        turns = [k for k in routes if k != "plain"]
        for name in turns + ["plain"]:
            res[f"{name} eager"] = median_ms(routes[name])
        for name in turns + turns[::-1] + ["plain"]:
            ms = graph_ms(routes[name])
            res[f"{name} graph"] = min(res.get(f"{name} graph", ms), ms)
        res["bound"] = product_bound(Sc, r)
        res["library"] = library_ms(
            f"{label} r={r}, expanded CSR" + (" @ X" if r > 1 else " mv"),
            (lambda: csr @ X) if r > 1 else (lambda: torch.mv(csr, X)), y,
            card)
        print(f"  {label} r={r}: graph ms colored {res['colored graph']:.4f}"
              f", serial {res['serial graph']:.4f}, old chain "
              f"{res['old chain graph']:.4f}, plain {res['plain graph']:.4f}"
              f", CSR {res['library'].graph}; eager colored "
              f"{res['colored eager']:.4f}, serial {res['serial eager']:.4f}"
              f", old chain {res['old chain eager']:.4f}, CSR "
              f"{float(res['library']):.4f}; bound {res['bound'][0]:.4f} "
              f"({res['bound'][1]}); launches {res['launches']} [{card}]")
        out[r] = res
    return out


def scattered_main_path(card: str) -> dict:
    """The bucket route as a main path: the config-2 recipe at n = 4096
    with scattered groups, whose f32 r = 1 products no stream plan takes.
    Under the default colored schedule both element passes win their
    colored plans and run the colored element route (per pass a products
    launch, two on the symmetric pass, and one B9 rounds launch; no
    one-call gather or scatter-add, forward or backward); under
    schedule="serial" each layout runs one B9 element pass.  S @ x and its
    gradient, counted exactly, against float64 scipy; S @ X at r = 64
    through the bucket route; then the cell timed (``colored_cell``) and
    the rounds alone (``rounds_alone``).  Returns the launches of each
    schedule's run and the times."""
    d, di, o, ri, ci, shape = random_symmetric(
        8, n=4096, ngroups=48, noffdiag=160, dtype=np.float32,
        contiguous=False)
    rng = np.random.default_rng(14)
    xn, wn = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    x, w = torch.from_numpy(xn).to(DEV), torch.from_numpy(wn).to(DEV)
    out, ops = {}, {}
    for schedule in ("colored", "serial"):
        S = ops[schedule] = bt.SymmetricBlockMatrix(
            d, di, o, ri, ci, shape, device=DEV, schedule=schedule)
        require(stream_kernel(S) == "B1", f"scattered {schedule}: no stream "
                f"plan should take S @ x ({stream_kernel(S)})")
        Ssc = bt.to_scipy(S).astype(np.float64)
        print(f"  scattered groups, schedule={schedule}: {S}; element passes "
              f"colored (diagonal, off-diagonal): {colored_passes(S)}; "
              f"{describe_passes(S)}")
        reset_counts()
        y = S @ x
        torch.cuda.synchronize()
        got = counts()
        print(f"  scattered {schedule} S @ x: launches "
              f"{ {k: v for k, v in got.items() if v} }")
        require_counts(f"scattered {schedule} S @ x", got, bucket_want(S))
        out[schedule] = dict(got)
        out[f"{schedule} entries"] = dict(fused_spmm.ENTRY_LAUNCHES)
        rel_check(f"scattered {schedule} S @ x vs float64 scipy", y,
                  Ssc @ xn.astype(np.float64), TOL32)
        before = counts()
        xg = x.clone().requires_grad_()
        (w * (S @ xg)).sum().backward()
        torch.cuda.synchronize()
        require_counts(f"scattered {schedule} S @ x and its backward",
                       grown_since(before), bucket_want(S, backward=True))
        rel_check(f"scattered {schedule} d(w . S @ x)/dx vs float64 scipy",
                  xg.grad, Ssc.T @ wn.astype(np.float64), TOL32)
        X = torch.from_numpy(rng.standard_normal((4096, 64)).astype(
            np.float32)).to(DEV)
        before = counts()
        Y = bucket_route_sym(S, X)
        torch.cuda.synchronize()
        require_counts(f"scattered {schedule} bucket-route S @ X r=64",
                       grown_since(before), bucket_want(S, r=64))
        rel_check(f"scattered {schedule} bucket-route S @ X r=64 vs float64 "
                  f"scipy", Y, Ssc @ X.double().cpu().numpy(), TOL32)
        out[f"{schedule} with backward"] = counts()
    col = out["colored"]
    require(col["B9 rounds"] > 0 and col["B9 colored"] > 0 and
            col["B9 gather"] == col["B9 scatter"] == 0 and
            out["colored with backward"]["B9 gather"] == 0 and
            out["colored with backward"]["B9 scatter"] == 0 and
            out["serial"]["B9 element"] > 0,
            f"the scattered main paths ran the wrong B9 kernels: {out}")
    Ssc = bt.to_scipy(ops["colored"]).astype(np.float64)
    out["times"] = colored_cell("scattered flagship", ops["colored"],
                                ops["serial"], Ssc, card)
    out["rounds"] = rounds_alone("scattered flagship", ops["colored"], card)
    out["products"] = products_alone("scattered flagship", ops["colored"],
                                     card)
    return out


# grown until both passes of the real-size colored cell take a plan
COLORED_REAL_NOFFDIAG = 4096


def colored_real_size(card: str) -> dict:
    """The real-size colored cell: phase 5's symmetric recipe (n = 32768,
    384 diagonal groups, ``COLORED_REAL_NOFFDIAG`` off-diagonal blocks)
    with scattered groups, under the default (colored) schedule: its
    passes (``describe_passes``), both taking a colored plan; its products
    at r = 1 and 64 through the bucket route timed (``colored_cell``) and
    the rounds alone (``rounds_alone``)."""
    args = random_symmetric(8, n=32768, ngroups=384,
                            noffdiag=COLORED_REAL_NOFFDIAG,
                            dtype=np.float32, contiguous=False)
    t0 = time.perf_counter()
    Sc = bt.SymmetricBlockMatrix(*args, device=DEV)
    torch.cuda.synchronize()
    t_ctor = time.perf_counter() - t0
    Ss = bt.SymmetricBlockMatrix(*args, device=DEV, schedule="serial")
    print(f"  real-size colored cell: {Sc}; constructor {t_ctor:.2f} s; "
          f"{describe_passes(Sc)}; S @ x's default route: "
          f"{stream_kernel(Sc)}")
    require(all(colored_passes(Sc)), "the real-size colored cell: a pass "
            "has no colored plan")
    Ssc = bt.to_scipy(Sc).astype(np.float64)
    return {"times": colored_cell("real-size colored cell", Sc, Ss, Ssc,
                                  card),
            "rounds": rounds_alone("real-size colored cell", Sc, card),
            "products": products_alone("real-size colored cell", Sc, card),
            "passes": describe_passes(Sc), "ctor_s": t_ctor}


# -- phase 5 -------------------------------------------------------------------

def b9_single_calls(S, x, gen, card) -> dict:
    """B9's one-call gather and scatter-add, each timed beside its plain
    version and one PyTorch call (index_select on x with its sentinel zero
    appended; index_add_ into a zeroed vector with the dropped slot): on
    the largest index table of S's element buckets (keys "gather",
    "scatter"), and on 2^20 random indices, every seventh the sentinel
    (keys "gather 1M", "scatter 1M"), where the card's time is device work
    rather than launch latency."""
    n = x.shape[0]
    big = torch.randint(0, n, (1 << 20,), generator=gen, dtype=torch.int32)
    big[::7] = n
    tables = {"": max((t for i in elem_ids(S._olayout)
                       for t in S._obuckets[i][1:3]),
                      key=lambda t: t.numel()).reshape(-1).contiguous(),
              " 1M": big.to(DEV)}
    x_ext = torch.cat([x, x.new_zeros(1)])
    out = {}
    for tag, idx in tables.items():
        v = torch.randn(idx.numel(), generator=gen).to(DEV)
        K, used = idx.numel(), int(torch.unique(idx[idx < n]).numel())
        calls = {
            "gather": (lambda: mask_select.mask_gather(x, idx),
                       lambda: mask_select.mask_gather_plain(x, idx),
                       lambda: torch.index_select(x_ext, 0, idx),
                       bound(2 * K * 4 + used * 4, 0)),
            "scatter": (lambda: mask_select.mask_scatter_add(v, idx, n),
                        lambda: mask_select.mask_scatter_add_plain(v, idx, n),
                        lambda: torch.zeros(n + 1, device=DEV).index_add_(
                            0, idx, v)[:n],
                        bound(2 * K * 4 + n * 4, K)),
        }
        for kind, (kern, plain, lib, bnd) in calls.items():
            label = f"B9 {kind}, one call on {K} indices (n={n})"
            before = counts()
            kern()
            torch.cuda.synchronize()
            launched = grown_since(before)[f"B9 {kind}"]
            p1, k1, k2, p2 = (median_ms(plain), median_ms(kern),
                              median_ms(kern), median_ms(plain))
            graph = graph_ms(kern)
            print(f"  {label}: kernel {k1:.4f} / {k2:.4f} ms (graph "
                  f"{graph:.4f} ms), plain {p1:.4f} / {p2:.4f} ms, bound "
                  f"{bnd[0] * 1e3:.3f} us ({bnd[1]}) [{card}]")
            out[kind + tag] = {"ms": min(k1, k2), "graph_ms": graph,
                               "plain_ms": min(p1, p2), "indices": K,
                               "launches": launched,
                               "library_ms": library_ms(label, lib, kern(),
                                                        card),
                               "bound": bnd}
    return out


def owner_stats(plan, bucket, n) -> dict:
    """B3's owner tables on one symmetric plan, from the tables it runs."""
    hb = plan.buckets[0]
    nchunks = -(-n // CC)
    stats = {"sentinel chunk slots": int((hb.col_chunk >= nchunks).sum()),
             "chunk slots": int(hb.col_chunk.size),
             "mirrored chunks": int(hb.mirror_kc.sum())}
    for mode, (chunk, ptr, pair) in zip(("symmetric", "adjoint"),
                                        bucket.owners):
        fan = (ptr[1:] - ptr[:-1]).cpu().numpy()
        stats[mode] = {"owners": int(chunk.numel()),
                       "pairs": int(pair.numel()),
                       "fan-in min/mean/max": (int(fan.min()),
                                               float(fan.mean()),
                                               int(fan.max()))}
    return stats


def b3_tiers(S, X, d_args, gen, card) -> dict:
    """B3 beside the default ("highest") operator's S @ X: at precision=None
    (a second operator built with it), in its adjoint mode (the dX of
    S @ X), and its forward blocks alone (an empty owner table), each
    checked and timed eager and from a CUDA graph."""
    n, r = X.shape
    plan, dev = S._patch_for(False)
    bucket = dev[0]
    vals, cc, rs, mk = bucket
    stats = owner_stats(plan, bucket, n)
    print(f"  B3 owner tables: {stats}")
    sym = stats["symmetric"]
    print(f"  B3 mirror adds per product: {sym['owners'] * CC * r} by "
          f"ownership, against {stats['mirrored chunks'] * CC * r} "
          f"(one per mirrored chunk and column)")
    Sn = bt.SymmetricBlockMatrix(*d_args, device=DEV, precision=None)
    before = counts()
    Yn = Sn @ X
    torch.cuda.synchronize()
    require_counts("S @ X at precision=None", grown_since(before),
                   {"B3": 1, "B2": 0})
    ref = plain_route_sym(S, X, dtype=torch.float64)
    out = {"none_err": rel_check("SpMM r=128 precision=None vs float64 plain",
                                 Yn, ref, TOL_TF32)}
    G = torch.randn((n, r), generator=gen).to(DEV)
    adjoint = lambda: patch_engine.bucket_spmm_sym(  # noqa: E731
        vals, cc, rs, mk, G, adjoint=True, owners=bucket.owners[True])
    out["adjoint_err"] = rel_check(
        "B3 adjoint (dX of S @ X) vs float64 plain", adjoint(),
        patch_engine.bucket_spmm_sym_plain(vals.double(), cc, rs, mk,
                                           G.double(), adjoint=True),
        TOL32)
    empty = tuple(torch.zeros(k, dtype=torch.int32, device=DEV)
                  for k in (0, 1, 0))
    full = {"highest": lambda: S @ X, None: lambda: Sn @ X}
    for prec in ("highest", None):
        fwd = lambda p=prec: patch_engine.bucket_spmm_sym(  # noqa: E731
            vals, cc, rs, mk, X, owners=empty, precision=p)
        t_full, t_fwd = graph_ms(full[prec]), graph_ms(fwd)
        out[f"forward blocks {prec}"] = t_fwd
        out[f"graph {prec}"] = t_full
        print(f"  B3 precision={prec}: full launch {t_full:.4f} ms, forward "
              f"blocks alone {t_fwd:.4f} ms, owner blocks' share "
              f"{max(0.0, 1 - t_fwd / t_full):.2f} (graph) [{card}]")
    eager = {"highest": [], None: []}
    for prec in ("highest", None, None, "highest"):
        eager[prec].append(median_ms(full[prec]))
    out["none"] = (min(eager[None]), out["graph None"])
    out["highest eager"] = min(eager["highest"])
    out["adjoint"] = (median_ms(adjoint), graph_ms(adjoint))
    print(f"  B3 S @ X eager highest {eager['highest'][0]:.4f} / "
          f"{eager['highest'][1]:.4f} ms, None {eager[None][0]:.4f} / "
          f"{eager[None][1]:.4f} ms; adjoint (dX) eager {out['adjoint'][0]:.4f}"
          f" ms, graph {out['adjoint'][1]:.4f} ms [{card}]")
    out["stats"] = stats
    return out


def grad_times(label, op, x, card) -> dict:
    """The gradient of an r = 1 product, d(w . op @ x)/dx, whose backward
    is the plain version's autograd on the stream plan
    (``StreamApply.backward``): eager, the backward alone; from a CUDA
    graph, forward and backward together less the forward's graph time."""
    w = torch.randn(x.shape[0], generator=torch.Generator().manual_seed(37)).to(DEV)
    xg = x.clone().requires_grad_()
    y = op @ xg
    out = {"eager_ms": median_ms(
        lambda: torch.autograd.grad(y, xg, w, retain_graph=True)[0])}
    try:
        both = graph_ms(lambda: torch.autograd.grad(op @ xg, xg, w)[0])
        out["graph_ms"] = both - graph_ms(lambda: op @ x)
        graph = f"graph {out['graph_ms']:.4f} ms (forward and backward less forward)"
    except RuntimeError as e:  # the capture fails: no graph time
        torch.cuda.synchronize()
        out["graph_ms"] = None
        graph = f"no graph time: the capture fails ({str(e).splitlines()[0]})"
    print(f"  {label} SpMV backward (plain autograd): eager "
          f"{out['eager_ms']:.4f} ms, {graph} [{card}]")
    return out


def symmetric_plan_rule(S, x, card) -> dict:
    """The measurement behind the H100 rule for a symmetric operand's v1
    plan (``ops/panel_router.py``): both candidate plans
    (``symmetric_candidates``), each B5 product checked against its plain
    version and timed eager and from a CUDA graph; their live-tile and
    table bytes; the mirror factor this run measures (the fused plan's
    graph time per live byte over the expanded plan's) beside the rule's
    ``MIRROR_FACTOR``; the plan each rule picks.  The route must read the
    plan the H100 rule picks."""
    t0 = time.perf_counter()
    fused, expanded = core_panel.symmetric_candidates(S._dlayout, S._olayout)
    out = {"host_s": time.perf_counter() - t0}
    for key, plan in (("fused", fused), ("expanded", expanded)):
        dev = panel_spmv.panel_device_arrays(plan, DEV)
        fn = lambda plan=plan, dev=dev: panel_spmv.panel_spmv(plan, dev, x)  # noqa: E731
        rel_check(f"B5 on the {key} plan vs plain", fn(),
                  panel_spmv.panel_apply_plain(plan, dev, x), TOL32)
        live = plan.nt * 4096
        out[key] = {"live_mb": live / 1e6, "tile_mb": plan.tile_bytes / 1e6,
                    "cost_mb": panel_router.b5_cost(plan) / 1e6,
                    "eager_ms": median_ms(fn), "graph_ms": graph_ms(fn),
                    "geometry": panel_spmv.panel_geometry(plan)}
        t = out[key]
        print(f"  {key} plan: {describe(plan)}; {b5_launch_text(plan)}; B5 "
              f"eager {t['eager_ms']:.4f} ms, graph {t['graph_ms']:.4f} ms = "
              f"{live / (t['graph_ms'] * 1e-3) / 1e9:.1f} GB/s of live tiles "
              f"[{card}]")
        del dev, fn
    f, e = out["fused"], out["expanded"]
    out["measured_factor"] = ((f["graph_ms"] / f["live_mb"])
                              / (e["graph_ms"] / e["live_mb"]))
    jax_cost = {k: core_panel._plan_cost(p) * (
        core_panel._MIRROR_RATE_PENALTY if p.mirror else 1.0)
        for k, p in (("fused", fused), ("expanded", expanded))}
    out["jax_pick"] = ("expanded" if jax_cost["expanded"] <= jax_cost["fused"]
                       else "fused")
    pick = panel_router.symmetric_choice(fused, expanded)
    out["h100_pick"] = "fused" if pick is fused else "expanded"
    print(f"  H100 rule: fused {f['cost_mb']:.1f} MB against expanded "
          f"{e['cost_mb']:.1f} MB (live tiles x MIRROR_FACTOR "
          f"{panel_router.MIRROR_FACTOR} on the fused plan, plus the tables "
          f"B5 stages) -> {out['h100_pick']}; this run measures a mirror "
          f"factor of {out['measured_factor']:.3f} (graph ms per live MB, "
          f"fused over expanded); the JAX rule (v5e: x1.4 and the one-hot "
          f"map-back) picks {out['jax_pick']} [{card}]")
    plan = S._stream_entry(False)[1]
    require(plan.mirror == pick.mirror and plan.nt == pick.nt,
            f"the symmetric SpMV reads {describe(plan)}, the H100 rule "
            f"picks the {out['h100_pick']} plan")
    return out


def phase5(card: str):
    print("phase 5: symmetric real size n=32768, 384 diagonal + 4096 "
          "off-diagonal f32 blocks (config-2 recipe x8)")
    d, di, o, ri, ci, shape = random_symmetric(
        8, n=32768, ngroups=384, noffdiag=4096, dtype=np.float32,
        contiguous=True)
    # split the constructor's host time by wrapping the functions it calls
    spent = {"layout": 0.0, "coloring": 0.0}

    def timed(key, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t
        return wrapped

    orig_layout = symmetric_format.build_layout
    orig_color = symmetric_format.coloring.color_blocks
    symmetric_format.build_layout = timed("layout", orig_layout)
    symmetric_format.coloring.color_blocks = timed("coloring", orig_color)
    try:
        t0 = time.perf_counter()
        S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device=DEV)
        torch.cuda.synchronize()
        t_ctor = time.perf_counter() - t0
    finally:
        symmetric_format.build_layout = orig_layout
        symmetric_format.coloring.color_blocks = orig_color
    t0 = time.perf_counter()
    plan, dev = S._patch_for(False)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    hb = plan.buckets[0]
    mirrored = int((hb.mirror_kc.astype(np.int64) * CC * hb.MP).sum())
    chunks = [b.chunk for b in S._olayout.buckets]
    stored = (S._dlayout.nnz + S._olayout.nnz) * 4
    print(f"  {S}; {stored / 1e6:.1f} MB of stored logical values, "
          f"{value_bytes_of(S._dlayout, S._olayout) / 1e6:.1f} MB of bucket "
          f"values; {len(S._dlayout.buckets)} diagonal + {len(chunks)} "
          f"off-diagonal buckets (chunks {min(chunks)}-{max(chunks)}, "
          f"{n_chunked(S._olayout)} chunked); {len(S.fusedcolors())} fused "
          f"colors")
    print(f"  symmetric patch plan: {hb.nb} slots of {hb.MP}x{hb.KP}, "
          f"{plan.value_bytes / 1e6:.1f} MB")
    print(f"  construction on the host: constructor {t_ctor:.2f} s (layout "
          f"{spent['layout']:.2f} s, coloring {spent['coloring']:.2f} s for "
          f"four colorings, staging to the card "
          f"{t_ctor - spent['layout'] - spent['coloring']:.2f} s), symmetric "
          f"patch plan {t_plan:.2f} s (built at the first r > 1 product)")
    gen = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn(shape[0], generator=gen).to(DEV)
    X = torch.randn((shape[0], 128), generator=gen).to(DEV)

    # B9 against its plain version on every element off-diagonal bucket
    errs = {"B9 gather": 0.0, "B9 scatter": 0.0}
    for i in elem_ids(S._olayout):
        _v, ridx, cidx, _rc, _cc = S._obuckets[i]
        for idx in (ridx, cidx):
            v = torch.randn(idx.numel(), generator=gen).to(DEV)
            for kind, got, ref in (
                    ("gather", mask_select.mask_gather(x, idx),
                     mask_select.mask_gather_plain(x, idx)),
                    ("scatter", mask_select.mask_scatter_add(v, idx, shape[0]),
                     mask_select.mask_scatter_add_plain(v, idx, shape[0]))):
                err = float((got - ref).abs().max())
                limit = TOL[torch.float32] * max(1.0, float(ref.abs().max()))
                require(err <= limit, f"B9 {kind} bucket {i}: error {err:.3e} "
                        f"above {limit:.3e}")
                errs[f"B9 {kind}"] = max(errs[f"B9 {kind}"], err)
    print(f"  B9 on the {len(elem_ids(S._olayout))} element off-diagonal "
          f"buckets (row and column tables): max_abs_err gather "
          f"{errs['B9 gather']:.3e}, scatter {errs['B9 scatter']:.3e} (tol "
          f"1e-5 x max(1, max|ref|) per call)")
    b9_single = b9_single_calls(S, x, gen, card)

    setup = stream_setup(S)
    require(stream_kernel(S) == "B5",
            "the symmetric real-size SpMV takes the panel route")
    rule = symmetric_plan_rule(S, x, card)
    reset_counts()
    y = S @ x
    Y = S @ X
    torch.cuda.synchronize()
    launched = counts()
    print(f"  launches: SpMV + SpMM r=128 -> {launched}")
    require_counts("real-size SpMV + SpMM r=128", launched,
                   dict(stream_want(S), B2=0, B3=1))
    rel_check("SpMV (B5) vs float64 plain", y,
              plain_route_sym(S, x, dtype=torch.float64), TOL[torch.float32])
    rel_check("SpMM r=128 vs float64 plain", Y,
              plain_route_sym(S, X, dtype=torch.float64), TOL[torch.float32])
    w = torch.randn(shape[0], generator=gen).to(DEV)
    xg = x.clone().requires_grad_()
    (w * (S @ xg)).sum().backward()
    rel_check("d(w . S @ x)/dx through B5 vs float64 plain S^T w", xg.grad,
              plain_buckets_sym(S, w, transpose=True, dtype=torch.float64),
              TOL[torch.float32])

    # the bucket route, driven explicitly: per layout one B1 launch over
    # its chunked buckets and one B9 element pass over its element buckets
    # (a pass under a colored plan keeps B9's one-call gathers), and its
    # backward
    print(f"  bucket route passes: {describe_passes(S)}")
    reset_counts()
    bucket_launched, errs["bucket route"] = check_bucket_route(
        "bucket-route SpMV (B1 + B9 element pass)", S, x)
    require(0 < bucket_launched["B1"] <= 2 and
            bucket_launched["B9 element"] <= 2,
            f"bucket-route SpMV: {bucket_launched['B1']} B1 launches and "
            f"{bucket_launched['B9 element']} element passes, at most 2 each")
    nbytes = value_bytes_of(S._dlayout, S._olayout)
    flops = 2 * sum(int(b.values.size) for b in S._dlayout.buckets) + \
        4 * sum(int(b.values.size) for b in S._olayout.buckets)
    splan = S._stream_entry(False)[1]
    times = {
        "SpMV": time_routes(
            "symmetric SpMV, stream route (B5)", lambda: S @ x,
            lambda: plain_route_sym(S, x), stream_bytes(S),
            2 * splan.tile_bytes // 4, card),
        "SpMV bucket": time_routes(
            "symmetric SpMV, bucket route (B1 + B9 element pass)",
            lambda: bucket_route_sym(S, x),
            lambda: plain_buckets_sym(S, x), nbytes, flops, card),
        "SpMM r=128": time_routes(
            "symmetric SpMM r=128", lambda: S @ X,
            lambda: plain_route_sym(S, X), plan.value_bytes,
            2 * 128 * (int(hb.vals.size) + mirrored), card),
        "setup": setup, "launches": launched["B5"], "B9 single": b9_single,
        "op": S, "rule": rule, "grad": grad_times("symmetric", S, x, card),
        "r1 bodies": r1_compare("symmetric real size S @ x, bucket route",
                                op_tables(S), x, card),
    }
    csr = csr_on_card([S])
    times["library"] = {
        "SpMM r=128": library_ms(
            "symmetric SpMM r=128, expanded CSR matrix @ X", lambda: csr @ X,
            Y, card),
        "SpMV": library_ms("symmetric SpMV, torch.mv on the expanded CSR "
                           "matrix", lambda: torch.mv(csr, x), y, card)}
    spmm_bytes = logical_nnz(S) * 4 + 2 * shape[0] * 128 * 4
    times["bound"] = {"SpMM r=128": bound(spmm_bytes, 2 * S.nnz * 128),
                      "SpMM r=128 None": bound(spmm_bytes, 2 * S.nnz * 128,
                                               None),
                      # the bucket values as stored, x and y once each
                      "SpMV bucket": bound(nbytes + 2 * shape[0] * 4, flops),
                      # the stored logical values, x and y once each
                      "SpMV": bound(stored + 2 * shape[0] * 4,
                                    2 * S._dlayout.nnz + 4 * S._olayout.nnz)}
    times["B3 tiers"] = b3_tiers(S, X, (d, di, o, ri, ci, shape), gen, card)

    split = bucket_split(S, x, card)
    errs.update(split.pop("errs"))
    times.update(split)
    return times, errs, bucket_launched


def describe_passes(op) -> str:
    """Which kernels each bucket-route pass of ``op`` runs."""
    out = []
    names = (("diagonal", "off-diagonal") if hasattr(op, "_dlayout")
             else ("one layout",))
    for (lay, colors, n, tr, sym, _a, _k), name in zip(passes_of(op), names):
        ids = elem_ids(lay)
        kind = "no element bucket"
        if ids:
            plan = pass_plan(lay, colors, n, tr, sym)
            kind = ("one B9 element pass" if plan is None else
                    f"the colored element route ({len(plan[0])} colors, "
                    f"{plan[1]} contribution rows: a products launch"
                    f"{' (two at r > 1)' if sym else ''} and a B9 rounds "
                    f"launch)")
        out.append(f"{name}: {n_chunked(lay)} chunked buckets in one B1 "
                   f"launch{' (symmetric)' if sym else ''}, {len(ids)} "
                   f"element buckets as {kind}")
    return "; ".join(out)


def bucket_split(S, x, card) -> dict:
    """The symmetric bucket route's parts, each replayed from its own CUDA
    graph: the diagonal pass, the off-diagonal B1 pass in one launch and as
    one-bucket launches, the element pass in one launch and as the
    per-bucket chain (B9's one-call kernels, or torch ops); then the
    element pass timed eager and from a graph beside its plain version, its
    bound and one library call (torch.mv on the CSR matrix of the same
    element blocks)."""
    n = x.shape[0]
    tabs = bucket_tables(S._obuckets, S._olayout)
    ctab, etab = tabs["chunked"], tabs["element"]

    def per_bucket_b1():
        y_ = x.new_zeros(n)
        for v, rc, cc, c in ctab.buckets:
            y_ = y_ + fused_spmm.chunked_block_apply(v, rc, cc, c, x, n,
                                                     symmetric=True)
        return y_

    def element_one_launch():
        return mask_select.element_apply(etab, x, out=x.new_zeros(n),
                                         symmetric=True)

    def b1_one_launch():
        return fused_spmm.multi_block_apply(ctab, x, out=x.new_zeros(n),
                                            symmetric=True)

    errs = {
        "B1 multi": rel_check(
            "B1 symmetric pass (one launch) vs its plain version",
            b1_one_launch(), fused_spmm.multi_block_apply_plain(
                ctab, x, out=x.new_zeros(n), symmetric=True), TOL32),
        "B9 element": rel_check(
            "element pass (one launch) vs its plain version",
            element_one_launch(), mask_select.element_apply_plain(
                etab, x, out=x.new_zeros(n), symmetric=True), TOL32)}
    parts = {
        "diagonal": lambda: apply_operand(S._dbuckets, S._dlayout, n, x,
                                          colors=S.diagonalcolors()),
        "B1 pass": b1_one_launch,
        "B1 pass per bucket": per_bucket_b1,
        "element pass": element_one_launch,
        "element pass per bucket (B9)":
            lambda: per_bucket_element_pass(S, x, True),
        "element pass per bucket (torch ops)":
            lambda: per_bucket_element_pass(S, x, False),
    }
    split = {name: graph_ms(fn) for name, fn in parts.items()}
    print(f"  symmetric bucket-route SpMV split, CUDA-graph replay "
          f"({len(ctab)} chunked, {len(etab)} element off-diagonal buckets; "
          f"'per bucket': one launch per bucket): " + ", ".join(
              f"{name} {ms:.4f} ms" for name, ms in split.items())
          + f" [{card}]")
    ids = torch.cat([t.reshape(-1) for b in etab.buckets for t in b[1:3]])
    used = int(torch.unique(ids[ids < n]).numel())
    ebytes = sum(v.numel() * v.element_size() + (ri.numel() + ci.numel()) * 4
                 for v, ri, ci, _c in etab.buckets) + 2 * used * 4
    eflops = 4 * sum(v.numel() for v in etab.values)
    cbytes = sum(v.numel() * v.element_size() + (rc.numel() + cc.numel()) * 4
                 for v, rc, cc, _c in ctab.buckets) + 2 * n * 4
    out = {"errs": errs, "split": split,
           "r1 pass": r1_compare("symmetric real size, the off-diagonal B1 "
                                 "symmetric pass alone", [(ctab, 2, "B1")], x,
                                 card),
           "B1 pass bound": bound(cbytes, 4 * sum(v.numel()
                                                  for v in ctab.values)),
           "element bound": bound(ebytes, eflops),
           "element pass": time_routes(
               "element pass (one B9 launch)", element_one_launch,
               lambda: mask_select.element_apply_plain(
                   etab, x, out=x.new_zeros(n), symmetric=True),
               ebytes, eflops, card)}
    csr = element_csr(etab, n, symmetric=True)
    out["element library"] = library_ms(
        "element pass, torch.mv on the CSR matrix of the element blocks",
        lambda: torch.mv(csr, x), element_one_launch(), card)
    print(f"  B1 symmetric pass bound {out['B1 pass bound'][0]:.4f} ms "
          f"({out['B1 pass bound'][1]}; {cbytes} bytes: values, chunk "
          f"tables, x and y) [{card}]")
    print(f"  element pass bound {out['element bound'][0] * 1e3:.3f} us "
          f"({out['element bound'][1]}; {ebytes} bytes: values, index "
          f"tables, {used} rows of x and of y) [{card}]")
    return out


# -- phase 6 -------------------------------------------------------------------

def config3_blocks(n: int, seed: int = 9, value_seed: int | None = None):
    """The config-3 recipe (``bench.py::build_config3``): a contiguous
    partition into groups of 16-128, six random block columns per block
    row, f32 values from ``seed + 7777`` (or ``value_seed``).  (blocks, row
    starts, col starts)."""
    rng = np.random.default_rng(seed)
    vrng = np.random.default_rng(seed + 7777 if value_seed is None
                                 else value_seed)
    bounds = [0]
    while bounds[-1] < n:
        bounds.append(min(n, bounds[-1] + int(rng.integers(16, 129))))
    groups = [(bounds[i], bounds[i + 1] - bounds[i])
              for i in range(len(bounds) - 1)]
    blocks, rs, cs = [], [], []
    for r0, h in groups:
        for gj in rng.choice(len(groups), size=min(6, len(groups)),
                             replace=False):
            c0, w = groups[int(gj)]
            blocks.append(vrng.standard_normal((h, w)).astype(np.float32))
            rs.append(r0)
            cs.append(c0)
    return blocks, rs, cs


def phase6():
    print("phase 6: VBCRS flagship, config-3 recipe n=4096 (seed 9, "
          "granularity (8, 128)), r=64")
    blocks, rs, cs = config3_blocks(4096)
    V = bt.VariableBlockCompressedRowStorage(
        blocks, rs, cs, (4096, 4096), granularity=(8, 128), device=DEV)
    Vsc = bt.to_scipy(V).astype(np.float64)
    print(f"  {V}; {V.nnz * 4 / 1e6:.1f} MB of logical values, "
          f"{value_bytes_of(V.layout) / 1e6:.1f} MB in "
          f"{len(V.layout.buckets)} buckets")
    setup = stream_setup(V)
    stream_setup(V, transpose=True)
    require(stream_kernel(V) == "B5",
            "the config-3 SpMV takes the panel route (the JAX decision)")
    rng = np.random.default_rng(9)
    xn, yn = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    Xn = rng.standard_normal((4096, 64)).astype(np.float32)
    x, y, X = (torch.from_numpy(a).to(DEV) for a in (xn, yn, Xn))
    x64, y64, X64 = (a.astype(np.float64) for a in (xn, yn, Xn))

    errs = {"B5": 0.0, "B5 duality": 0.0}
    for tr in (False, True):
        choice, plan, dev = V._stream_entry(tr)
        if choice == "panel":
            check_b5(f"V{'.T' if tr else ''} ({describe(plan)})", plan, dev,
                     x, errs)

    spmm = ("B2 transpose" if patch_wins(V._patch_for()[0], [(V.layout, 1)], 64)
            else "B1")
    # (name, product, reference, transpose of its stream product or None
    # for r > 1, applications of V)
    products = [
        ("V @ x", lambda: V @ x, Vsc @ x64, False, 1),
        ("V.T @ x", lambda: V.T @ x, Vsc.T @ x64, True, 1),
        ("V.H @ X", lambda: V.H @ X, Vsc.T @ X64, None, 0),
        ("V.axpby(x, y, 2.0, 0.5)", lambda: V.axpby(x, y, 2.0, 0.5),
         2.0 * (Vsc @ x64) + 0.5 * y64, False, 1),
        ("(V @ V) @ x", lambda: (V @ V) @ x, Vsc @ (Vsc @ x64), False, 2),
    ]
    reset_counts()
    outs = []
    for name, fn, _ref, tr, k in products:
        before = counts()
        outs.append(fn())
        grown = grown_since(before)
        if tr is None:
            require(grown[spmm] > 0, f"{name}: kernel {spmm} was not launched")
            require(spmm == "B1" or grown["B2 prologue"] == grown[spmm],
                    f"{name}: one prologue per transposed launch, got {grown}")
        else:
            require_counts(name, grown, stream_want(V, tr, k))
    torch.cuda.synchronize()
    launches = counts()
    print(f"  main-path launches: {launches} (V.H @ X through {spmm})")
    for (name, _fn, ref, *_), out in zip(products, outs):
        rel_check(f"{name} vs float64 scipy", out, ref, TOL[torch.float32])
    wn = rng.standard_normal(4096).astype(np.float32)
    before = counts()
    xg = x.clone().requires_grad_()
    (torch.from_numpy(wn).to(DEV) * (V @ xg)).sum().backward()
    rel_check("d(w . V @ x)/dx vs float64 scipy V^T w", xg.grad,
              Vsc.T @ wn.astype(np.float64), TOL[torch.float32])
    require(grown_since(before)["B5"] == 1, "the gradient's product skipped B5")
    launches["setup"] = setup
    return errs, launches


# -- phase 7 -------------------------------------------------------------------

def phase7(card: str):
    print("phase 7: VBCRS real size, config-3 recipe n=32768 (seed 9, "
          "granularity (8, 128))")
    blocks, rs, cs = config3_blocks(32768)
    spent = {"layout": 0.0}
    orig_layout = vbcrs_format.build_layout

    def timed_layout(*a, **k):
        t = time.perf_counter()
        try:
            return orig_layout(*a, **k)
        finally:
            spent["layout"] += time.perf_counter() - t

    vbcrs_format.build_layout = timed_layout
    try:
        t0 = time.perf_counter()
        V = bt.VariableBlockCompressedRowStorage(
            blocks, rs, cs, (32768, 32768), granularity=(8, 128), device=DEV)
        torch.cuda.synchronize()
        t_ctor = time.perf_counter() - t0
    finally:
        vbcrs_format.build_layout = orig_layout
    logical = V.nnz * 4
    padded = value_bytes_of(V.layout)
    print(f"  {V}; {logical / 1e6:.1f} MB of logical values, "
          f"{padded / 1e6:.1f} MB in {len(V.layout.buckets)} buckets "
          f"({n_chunked(V.layout)} chunked)")
    print(f"  construction on the host: constructor {t_ctor:.2f} s (layout "
          f"{spent['layout']:.2f} s, sort and staging "
          f"{t_ctor - spent['layout']:.2f} s)")
    setup = stream_setup(V)
    require(stream_kernel(V) == "B5",
            "the config-3 real-size SpMV takes the panel route (the JAX "
            "decision)")
    gen = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(32768, generator=gen).to(DEV)
    reset_counts()
    y = V @ x
    torch.cuda.synchronize()
    launched = counts()
    print(f"  launches: SpMV -> {launched}")
    require_counts("real-size SpMV", launched, stream_want(V))
    ref = plain_buckets(V.layout, V._buckets, x.double(), 32768, torch.float64)
    rel_check("SpMV (B5) vs float64 plain bucket route", y, ref,
              TOL[torch.float32])
    rel_check("SpMV (B5) vs float64 plain stream route", y,
              plain_route(V, x, dtype=torch.float64), TOL[torch.float32])
    print(f"  bucket route passes: {describe_passes(V)}")
    bucket_launched, _ = check_bucket_route("bucket-route SpMV (B1)", V, x)

    errs = {"B5": 0.0, "B5 duality": 0.0, "B8": 0.0, "B8 duality": 0.0}
    _, pplan, pdev = V._stream_entry(False)
    check_b5("at the real size", pplan, pdev, x, errs)
    splan = V._strip_for(False)
    t0 = time.perf_counter()
    sdev = slab_spmv.plan_device_arrays(splan, DEV)
    torch.cuda.synchronize()
    print(f"  slab plan staged in {time.perf_counter() - t0:.2f} s (B8 wins "
          f"no route decision here; it is timed on this operand's plan)")
    check_stream_kernel("B8 at the real size", slab_spmv.slab_spmv,
                        slab_spmv.slab_apply_plain, splan, sdev, x, errs)
    rel_check("B8 vs float64 plain bucket route",
              slab_spmv.slab_spmv(splan, sdev, x), ref, TOL[torch.float32])
    sbytes = sum(t.numel() * t.element_size() for t in sdev)
    times = {
        "SpMV": time_routes(
            "VBCRS SpMV, stream route (B5)", lambda: V @ x,
            lambda: plain_route(V, x), stream_bytes(V),
            2 * pplan.tile_bytes // 4, card),
        "SpMV bucket": time_routes(
            "VBCRS SpMV, bucket route (B1)", lambda: bucket_route(V, x),
            lambda: plain_buckets(V.layout, V._buckets, x, 32768,
                                  torch.float32),
            padded, 2 * padded // 4, card),
        "B8": time_routes(
            "B8 on the slab plan", lambda: slab_spmv.slab_spmv(splan, sdev, x),
            lambda: slab_spmv.slab_apply_plain(splan, sdev, x), sbytes,
            2 * splan.tile_bytes // 4, card),
        "setup": setup, "launches": launched["B5"], "op": V,
        "bucket launches": bucket_launched,
        "grad": grad_times("VBCRS", V, x, card),
        "r1 bodies": r1_compare("VBCRS A @ x, bucket route", op_tables(V), x,
                                card),
    }
    csr = csr_on_card([V])
    times["library"] = {"SpMV": library_ms(
        "VBCRS SpMV, torch.mv on the CSR matrix", lambda: torch.mv(csr, x), y,
        card)}
    times["bound"] = {"SpMV": bound(V.nnz * 4 + 2 * 32768 * 4, 2 * V.nnz)}
    for key in ("SpMV", "SpMV bucket"):
        eager, _, graph, _ = times[key]
        print(f"  {key}: {logical / (graph * 1e-3) / 1e9:.1f} GB/s of logical "
              f"values from the graph replay ({logical / 1e6:.1f} MB), "
              f"{logical / (eager * 1e-3) / 1e9:.1f} GB/s eager [{card}]")
    return times, errs


# -- phase 8 -------------------------------------------------------------------

def strided_operator(n: int, nblocks: int, seed: int, device):
    """nblocks aligned 64x128 f32 blocks (positions drawn with repeats, so
    some overlap and sum) and one 64x128 block whose rows run at stride 4."""
    rng = np.random.default_rng(seed)
    blocks, rows, cols = [], [], []
    for _ in range(nblocks):
        r0 = int(rng.integers(0, n // 64)) * 64
        c0 = int(rng.integers(0, n // 128)) * 128
        blocks.append(rng.standard_normal((64, 128)).astype(np.float32))
        rows.append(np.arange(r0, r0 + 64))
        cols.append(np.arange(c0, c0 + 128))
    r0, c0 = int(rng.integers(0, n - 256)), int(rng.integers(0, n // 128)) * 128
    blocks.append(rng.standard_normal((64, 128)).astype(np.float32))
    rows.append(r0 + 4 * np.arange(64))
    cols.append(np.arange(c0, c0 + 128))
    return bt.BlockSparseMatrix(blocks, rows, cols, (n, n), device=device)


def phase8(card: str):
    print("phase 8: the slab route, n=8192, 4000 aligned 64x128 f32 blocks + "
          "one block with rows at stride 4")
    A = strided_operator(8192, 4000, 3, DEV)
    print(f"  {A}; {value_bytes_of(A.layout) / 1e6:.1f} MB of bucket values")
    setup = stream_setup(A)
    require(stream_kernel(A) == "B8",
            "this operand's SpMV takes the slab route (the JAX decision)")
    gen = torch.Generator(device="cpu").manual_seed(12)
    x = torch.randn(8192, generator=gen).to(DEV)
    y = torch.randn(8192, generator=gen).to(DEV)
    errs = {"B8": 0.0, "B8 duality": 0.0}
    _, plan, dev = A._stream_entry(False)
    check_stream_kernel("B8 at this operand's plan", slab_spmv.slab_spmv,
                        slab_spmv.slab_apply_plain, plan, dev, x, errs)
    reset_counts()
    out = A @ x
    out2 = A.axpby(x, y, 2.0, 0.5)
    torch.cuda.synchronize()
    launched = counts()
    print(f"  main-path launches: A @ x + axpby -> {launched}")
    require_counts("A @ x + axpby", launched, stream_want(A, False, 2))
    ref = plain_buckets(A.layout, A._buckets, x.double(), 8192, torch.float64)
    rel_check("A @ x (B8) vs float64 plain bucket route", out, ref,
              TOL[torch.float32])
    rel_check("A.axpby(x, y, 2.0, 0.5) (B8) vs float64 plain bucket route",
              out2, 2.0 * ref + 0.5 * y.double(), TOL[torch.float32])
    times = {
        "SpMV": time_routes(
            "slab-route SpMV (B8)", lambda: A @ x, lambda: plain_route(A, x),
            stream_bytes(A), 2 * plan.tile_bytes // 4, card),
        "SpMV bucket": time_routes(
            "bucket-route SpMV (B1 + B9 element pass)",
            lambda: bucket_route(A, x),
            lambda: plain_buckets(A.layout, A._buckets, x, 8192,
                                  torch.float32),
            value_bytes_of(A.layout), 2 * value_bytes_of(A.layout) // 4,
            card),
        "setup": setup, "launches": launched["B8"],
    }
    csr = csr_on_card([A])
    times["library"] = {"SpMV": library_ms(
        "slab-route SpMV, torch.mv on the CSR matrix",
        lambda: torch.mv(csr, x), out, card)}
    times["bound"] = {"SpMV": bound(A.nnz * 4 + 2 * 8192 * 4, 2 * A.nnz)}
    return times, errs


# -- phase 9 -------------------------------------------------------------------

def config1_operators(n: int, nblocks: int, bs: int, P: int) -> list:
    """bench.py's config-1 / config-4 batch: one structure (seed 7), values
    from seed 7 + 7777 for the first operator and 100 + i for the others."""
    return [contiguous_operator(n, nblocks, bs, seed=7,
                                value_seed=100 + i if i else 7 + 7777,
                                device=DEV)[0] for i in range(P)]


def config2_operators(P: int) -> list:
    """bench.py's config-2 batch: the symmetric recipe (seed 8, n = 4096),
    values rerolled from seed 200 + i after the first operator, diagonal
    blocks symmetrized as bench.py does."""
    d, di, o, ri, ci, shape = random_symmetric(
        8, n=4096, ngroups=48, noffdiag=160, dtype=np.float32, contiguous=True)
    ops = []
    for i in range(P):
        dd, oo = d, o
        if i:
            vr = np.random.default_rng(200 + i)
            dd = []
            for blk in d:
                b = vr.standard_normal(blk.shape)
                dd.append(((b + b.T) / 2).astype(np.float32))
            oo = [vr.standard_normal(b.shape).astype(np.float32) for b in o]
        ops.append(bt.SymmetricBlockMatrix(dd, di, oo, ri, ci, shape,
                                           device=DEV))
    return ops


def config3_operators(n: int, P: int) -> list:
    """bench.py's config-3 batch: one structure (seed 9), values from seed
    9 + 7777 for the first operator and 300 + i for the others."""
    ops = []
    for i in range(P):
        blocks, rs, cs = config3_blocks(n, value_seed=300 + i if i else None)
        ops.append(bt.VariableBlockCompressedRowStorage(
            blocks, rs, cs, (n, n), granularity=(8, 128), device=DEV))
    return ops


def scipy_refs(ops, X: torch.Tensor) -> list:
    """float64 scipy products ops[p] @ X[p] (X on the host)."""
    return [bt.to_scipy(op).astype(np.float64) @ X[p].double().numpy()
            for p, op in enumerate(ops)]


def scipy_grads(ops, W: torch.Tensor) -> list:
    """float64 scipy ops[p]^T @ W[p]: the gradient of sum(W * batch)."""
    return [bt.to_scipy(op).astype(np.float64).T @ W[p].double().numpy()
            for p, op in enumerate(ops)]


def time_batch(label, routes: dict, nbytes, flops, card) -> dict:
    """Median CUDA-event times of the routes of one batch, eager in the
    order given and then reversed (the lower of the two kept), and replayed
    from a CUDA graph; the library call eager only."""
    names = list(routes)
    eager = {name: [] for name in names}
    for name in names + names[::-1]:
        eager[name].append(median_ms(routes[name]))
    out = {}
    for name in names:
        ms = min(eager[name])
        graph = graph_ms(routes[name]) if name != "library" else None
        out[name] = (ms, graph)
        rate = (f", {nbytes / (graph * 1e-3) / 1e9:.1f} GB/s = "
                f"{100 * nbytes / (graph * 1e-3) / HBM_BYTES_PER_S:.1f}% of "
                f"3.35 TB/s, {flops / (graph * 1e-3) / 1e12:.2f} TFLOP/s "
                f"(graph)" if graph else "")
        print(f"  {label}, {name}: eager {eager[name][0]:.4f} / "
              f"{eager[name][1]:.4f} ms"
              + (f", graph {graph:.4f} ms" if graph else "") + rate
              + f" [{card}]")
    return out


def batched_mm_step(label, ops, gen, want_b2_loop: bool):
    """One batched_mm batch on the main path: exactly one B4 launch and no
    other, each product against float64 scipy, and the gradient in Xs (B4
    forward, then one prologue and one B2 transposed launch for the P
    products' dX)."""
    P, n = len(ops), ops[0].shape[1]
    require(batched._stacked_entry(ops) is not None,
            f"{label}: the batch must take B4 (the JAX decision)")
    X = torch.randn((P, n, 128), generator=gen)
    Xd = X.to(DEV)
    reset_counts()
    Y = bt.batched_mm(ops, Xd)
    torch.cuda.synchronize()
    got = counts()
    print(f"  batched_mm {label}: launches {got}")
    require_counts(f"batched_mm {label}", got,
                   {"B4": 1, "B1": 0, "B2": 0, "B3": 0, "B5": 0, "B6": 0})
    err = batch_check(f"batched_mm {label} P={P} r=128 vs float64 scipy", Y,
                      scipy_refs(ops, X))
    W = torch.randn((P, n, 128), generator=gen)
    Xg = Xd.clone().requires_grad_()
    before = counts()
    (W.to(DEV) * bt.batched_mm(ops, Xg)).sum().backward()
    torch.cuda.synchronize()
    grad = grown_since(before)
    require_counts(f"gradient of batched_mm {label}", grad,
                   {"B4": 1, "B2 transpose": 1, "B2 prologue": 1, "B2": 0})
    batch_check(f"d(W . batched_mm {label})/dXs vs float64 scipy A_p^T W_p",
                Xg.grad, scipy_grads(ops, W))
    if want_b2_loop:
        before = counts()
        torch.stack([op @ Xd[p] for p, op in enumerate(ops)])
        require_counts(f"loop of {label}", grown_since(before),
                       {"B2": P, "B4": 0})
    return got["B4"], grad["B2 transpose"], err


def batched_dx(ops, vals_b, cc, rs, gen, card) -> dict:
    """The dX of batched_mm at the real size: B2's transposed product at
    P = 4 (one prologue and one transposed launch) at both tiers, against
    the float64 plain version, timed beside the plain version and the
    block-diagonal transposed CSR matrix @ G, with its bound."""
    P, n, r = len(ops), ops[0].shape[1], 128
    G = torch.randn((P, n, r), generator=gen).to(DEV)
    dx = {prec: (lambda p=prec: batched_spmm.batched_spmm(
        vals_b, cc, rs, G, n, transpose=True, precision=p))
        for prec in ("highest", None)}
    before = counts()
    got = {prec: fn() for prec, fn in dx.items()}
    torch.cuda.synchronize()
    require_counts("batched_mm dX at both tiers", grown_since(before),
                   {"B2 transpose": 2, "B2 prologue": 2, "B4": 0, "B2": 0})
    ref = batched_spmm.batched_spmm_plain(vals_b.double(), cc, rs, G.double(),
                                          n, transpose=True)
    out = {"errs": {prec: batch_check(
        f"batched_mm dX P={P} precision={prec} vs float64 plain", got[prec],
        list(ref), TIER_TOL[prec]) for prec in dx}}
    del ref
    nnz = sum(op.nnz for op in ops)
    nbytes, flops = nnz * 4 + 2 * P * n * r * 4, 2 * nnz * r
    csr_t = csr_on_card(ops, transpose=True)
    out.update(time_batch("batched_mm dX real size", {
        "highest": dx["highest"], "none": dx[None],
        "plain": lambda: batched_spmm.batched_spmm_plain(
            vals_b, cc, rs, G, n, transpose=True)}, nbytes, flops, card))
    out["library"] = library_ms(
        "batched_mm dX real size, block-diagonal transposed CSR matrix @ "
        "stacked G", lambda: csr_t @ G.reshape(P * n, r),
        got["highest"].reshape(P * n, r), card)
    out["bound"], out["bound none"] = (bound(nbytes, flops),
                                       bound(nbytes, flops, None))
    for key, prec in (("highest", "highest"), ("none", None)):
        bnd = out["bound none" if prec is None else "bound"]
        print(f"  batched_mm dX precision={prec}: graph {out[key][1]:.4f} ms "
              f"against its bound {bnd[0]:.4f} ms ({bnd[1]}): "
              f"{100 * bnd[0] / out[key][1]:.1f}% of the bound [{card}]")
    return out


def batched_mv_step(label, ops, gen, card):
    """One batched_mv batch on the main path: exactly one B6 launch (a
    mirror launch for a fused mirror plan) and no B5, each product against
    float64 scipy, its gradient in xs, and its times beside the loop of P
    B5 launches, B6's plain version and the library call."""
    P, n = len(ops), ops[0].shape[1]
    t0 = time.perf_counter()
    entry = batched._stacked_panel_entry(ops)
    torch.cuda.synchronize()
    t_stack = time.perf_counter() - t0
    require(entry is not None, f"{label}: the batch must take B6 (the JAX "
            f"decision)")
    plan, tables, vals_b = entry
    print(f"  batched_mv {label}: P={P}, plan {describe(plan)}; host plans "
          f"and stacking {t_stack:.2f} s, {vals_b.numel() * 4 / 1e6:.1f} MB "
          f"of stacked values")
    x = torch.randn((P, n), generator=gen)
    xd = x.to(DEV)
    reset_counts()
    y = bt.batched_mv(ops, xd)
    torch.cuda.synchronize()
    got = counts()
    print(f"  batched_mv {label}: launches {got}")
    require_counts(f"batched_mv {label}", got,
                   {"B6": 1, "B6 mirror": int(plan.mirror), "B5": 0, "B1": 0,
                    "B8": 0, "B9 gather": 0})
    err = batch_check(f"batched_mv {label} P={P} vs float64 scipy", y,
                      scipy_refs(ops, x))
    w = torch.randn((P, n), generator=gen)
    xg = xd.clone().requires_grad_()
    before = counts()
    (w.to(DEV) * bt.batched_mv(ops, xg)).sum().backward()
    torch.cuda.synchronize()
    require_counts(f"gradient of batched_mv {label}", grown_since(before),
                   {"B6": 1, "B5": 0})
    batch_check(f"d(w . batched_mv {label})/dxs vs float64 scipy A_p^T w_p",
                xg.grad, scipy_grads(ops, w))
    before = counts()
    torch.stack([op @ xd[p] for p, op in enumerate(ops)])
    torch.cuda.synchronize()
    require_counts(f"loop of {label}", grown_since(before), {"B5": P, "B6": 0})
    csr = csr_on_card(ops)
    nnz = sum(logical_nnz(op) for op in ops)
    flops = 2 * sum(op.nnz for op in ops)
    nbytes = nnz * 4 + 2 * P * n * 4
    times = time_batch(f"batched_mv {label}", {
        "B6": lambda: bt.batched_mv(ops, xd),
        "loop": lambda: torch.stack([op @ xd[p] for p, op in enumerate(ops)]),
        "plain": lambda: panel_spmv.panel_apply_batched_plain(
            plan, tables, vals_b, xd),
    }, nbytes, flops, card)
    times["library"] = library_ms(
        f"batched_mv {label}, torch.mv on the block-diagonal CSR matrix",
        lambda: torch.mv(csr, xd.reshape(-1)), y.reshape(-1), card)
    times["bound"] = bound(nbytes, flops)
    times["stack_s"] = t_stack
    return got, err, times


def phase9(card: str):
    print("phase 9: batched products (bench.py's batches: one structure, "
          "values from seeds 100+i / 200+i / 300+i)")
    gen = torch.Generator(device="cpu").manual_seed(13)
    out = {"errs": {"B4": 0.0, "B4 tf32": 0.0, "B6": 0.0}, "launches": {}}
    errs, launches = out["errs"], out["launches"]

    # 9.1 batched_mm at r = 128, one B4 launch per batch, and its gradient
    launches["B2 transpose"] = 0
    for key, label, ops in (
            ("config 4", "config 4 (n=4096, 200 x 64x64 BSM)",
             config1_operators(4096, 200, 64, 4)),
            ("config 3", "config 3 (n=4096, VBCRS)", config3_operators(4096, 4))):
        launches[f"B4 {key}"], dx, err = batched_mm_step(label, ops, gen,
                                                          key == "config 4")
        launches["B2 transpose"] += dx
        errs["B4"] = max(errs["B4"], err)

    # 9.2 batched_mm at the real size, timed
    print("  batched_mm real size: n=8192, 2000 x 128x128 f32 (config-1 "
          "recipe), P=4, r=128")
    ops = config1_operators(8192, 2000, 128, 4)
    (P, n), r = (len(ops), ops[0].shape[1]), 128
    t0 = time.perf_counter()
    plan, vals_b, cc, rs = batched._stacked_entry(ops)
    torch.cuda.synchronize()
    out["mm stack_s"] = time.perf_counter() - t0
    print(f"  patch plans and stacking {out['mm stack_s']:.2f} s: "
          f"{plan.buckets[0].nb} slots of {plan.buckets[0].MP}x"
          f"{plan.buckets[0].KP} per product, {vals_b.numel() * 4 / 1e6:.1f} "
          f"MB stacked")
    X = torch.randn((P, n, r), generator=gen).to(DEV)
    reset_counts()
    Y = bt.batched_mm(ops, X)
    torch.cuda.synchronize()
    got = counts()
    require_counts("batched_mm real size", got, {"B4": 1, "B2": 0, "B1": 0})
    launches["B4 real size"] = got["B4"]
    refs64 = [plain_route(op, X[p], dtype=torch.float64)
              for p, op in enumerate(ops)]
    errs["B4"] = max(errs["B4"], batch_check(
        "batched_mm real size vs float64 plain route", Y, refs64))
    before = counts()
    loop_out = torch.stack([op @ X[p] for p, op in enumerate(ops)])
    torch.cuda.synchronize()
    require_counts("loop of the real size", grown_since(before),
                   {"B2": P, "B4": 0})
    batch_check("batched_mm real size vs the loop of B2 launches", Y,
                list(loop_out))
    # B4 at precision=None: the kernel wrapper at the batch's tables (the
    # operators here are "highest", and batched_mm takes their tier)
    fast = lambda: batched_spmm.batched_spmm(  # noqa: E731
        vals_b, cc, rs, X, n, precision=None)
    errs["B4 tf32"] = batch_check(
        "B4 real size precision=None vs float64 plain route", fast(), refs64,
        TOL_TF32)
    del refs64
    nnz = sum(op.nnz for op in ops)
    nbytes, flops = nnz * 4 + 2 * P * n * r * 4, 2 * nnz * r
    csr = csr_on_card(ops)
    times = time_batch("batched_mm real size", {
        "B4": lambda: bt.batched_mm(ops, X),
        "B4 none": fast,
        "loop": lambda: torch.stack([op @ X[p] for p, op in enumerate(ops)]),
        "plain": lambda: batched_spmm.batched_spmm_plain(vals_b, cc, rs, X, n),
    }, nbytes, flops, card)
    times["library"] = library_ms(
        "batched_mm real size, block-diagonal CSR matrix @ stacked X",
        lambda: csr @ X.reshape(P * n, r), Y.reshape(P * n, r), card)
    times["bound"] = bound(nbytes, flops)
    times["bound none"] = bound(nbytes, flops, None)
    for key, prec in (("B4", "highest"), ("B4 none", None)):
        bnd = times["bound none" if prec is None else "bound"]
        print(f"  B4 precision={prec}: graph {times[key][1]:.4f} ms against "
              f"its bound {bnd[0]:.4f} ms ({bnd[1]}): "
              f"{100 * bnd[0] / times[key][1]:.1f}% of the bound [{card}]")
    out["mm"] = times
    del csr, Y, loop_out
    out["dX"] = batched_dx(ops, vals_b, cc, rs, gen, card)
    del vals_b, X, ops

    # 9.3 batched_mv at P = 16, one B6 launch per batch
    for key, label, ops in (
            ("config 2", "config 2 (n=4096, symmetric)", config2_operators(16)),
            ("config 3", "config 3 (n=4096, VBCRS)", config3_operators(4096, 16))):
        got, err, times = batched_mv_step(label, ops, gen, card)
        launches[f"B6 {key}"] = got["B6"]
        launches[f"B6 mirror {key}"] = got["B6 mirror"]
        errs["B6"] = max(errs["B6"], err)
        out[f"mv {key}"] = times
    require(launches["B6 mirror config 2"] == 1,
            "the config-2 batch must run B6 on the fused mirror plan")

    # 9.4 above the cap: the batch loops; B6 driven directly on the stack
    print("  above the cap: config 3 at n=32768, P=4")
    ops = config3_operators(32768, 4)
    P, n = len(ops), ops[0].shape[1]
    x = torch.randn((P, n), generator=gen)
    xd = x.to(DEV)
    reset_counts()
    y = bt.batched_mv(ops, xd)
    torch.cuda.synchronize()
    got = counts()
    print(f"  batched_mv above the cap: launches {got}")
    plans = [op._panel_for(False) for op in ops]
    require(plans[0].tile_bytes > batched._BATCHED_PANEL_TILE_CAP,
            "the n=32768 panel plan must exceed the batched cap")
    require_counts("batched_mv above the cap", got, {"B5": P, "B6": 0})
    refs = scipy_refs(ops, x)
    batch_check("batched_mv above the cap (loop) vs float64 scipy", y, refs)
    t0 = time.perf_counter()
    plan, tables, vals_b = batched._panel_stack(ops, plans)
    torch.cuda.synchronize()
    t_stack = time.perf_counter() - t0
    print(f"  stacked plan past the cap: {describe(plan)} per product, "
          f"{vals_b.numel() * 4 / 1e6:.1f} MB stacked in {t_stack:.2f} s")
    direct = panel_spmv.panel_spmv_batched(plan, tables, vals_b, xd)
    errs["B6"] = max(errs["B6"], batch_check(
        "B6 on the stacked plan past the cap vs float64 scipy", direct, refs))
    nnz = sum(op.nnz for op in ops)
    capped = time_batch("B6 past the cap", {
        "B6": lambda: panel_spmv.panel_spmv_batched(plan, tables, vals_b, xd),
        "loop": lambda: torch.stack([op @ xd[p] for p, op in enumerate(ops)]),
    }, nnz * 4 + 2 * P * n * 4, 2 * nnz, card)
    capped["bound"] = bound(nnz * 4 + 2 * P * n * 4, 2 * nnz)
    out["mv capped"] = capped
    return out


# -- phases 10 and 11 ------------------------------------------------------------

REAL = {"bsm": "BSM n=8192, 2000 x 128x128 (config 1)",
        "sym": "symmetric n=32768, 384 + 4096 blocks (config 2 x8)",
        "vbcrs": "VBCRS n=32768 (config 3)"}


def real_operand(key: str, **opts):
    """Phase 3's, 5's or 7's operand, built anew with the route options
    ``opts``; the constructor's host seconds."""
    t0 = time.perf_counter()
    if key == "bsm":
        op = contiguous_operator(8192, 2000, 128, seed=7, value_seed=7 + 7777,
                                 device=DEV, **opts)[0]
    elif key == "sym":
        d, di, o, ri, ci, shape = random_symmetric(
            8, n=32768, ngroups=384, noffdiag=4096, dtype=np.float32,
            contiguous=True)
        op = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device=DEV,
                                     **opts)
    else:
        blocks, rs, cs = config3_blocks(32768)
        op = bt.VariableBlockCompressedRowStorage(
            blocks, rs, cs, (32768, 32768), granularity=(8, 128), device=DEV,
            **opts)
    torch.cuda.synchronize()
    return op, time.perf_counter() - t0


def real_x(key: str) -> torch.Tensor:
    """The operand vector of ``key`` in phases 10 and 11 (the same x, so
    one library call serves both)."""
    n = 8192 if key == "bsm" else 32768
    seed = {"bsm": 21, "sym": 22, "vbcrs": 23}[key]
    return torch.randn(n, generator=torch.Generator().manual_seed(seed)).to(DEV)


def float64_reference(op, x, transpose=False) -> torch.Tensor:
    """The bucket route through the plain versions in float64."""
    if hasattr(op, "_dlayout"):
        return plain_buckets_sym(op, x, transpose=transpose,
                                 dtype=torch.float64)
    n_out = op.shape[1] if transpose else op.shape[0]
    return plain_buckets(op.layout, op._buckets, x.double(), n_out,
                         torch.float64, transpose=transpose)


def default_beside(label, default, x, card) -> tuple:
    """(eager, graph) ms of the default operator's product (B5), timed
    beside a route of phases 10 and 11."""
    fn = lambda: default @ x  # noqa: E731
    eager = min(median_ms(fn), median_ms(fn))
    graph = graph_ms(fn)
    print(f"  {label}, default operator ({stream_kernel(default)}): eager "
          f"{eager:.4f} ms, graph {graph:.4f} ms [{card}]")
    return eager, graph


def phase10(card: str, defaults: dict):
    print("phase 10: the r = 1 patch route (B7), patch='always', on the "
          "operands of phases 3, 5 and 7")
    out = {"errs": {"B7": 0.0, "B7 duality": 0.0, "B7 float64": 0.0},
           "launches": {}, "times": {}, "library": {}}
    errs = out["errs"]
    for key, label in REAL.items():
        op, t_ctor = real_operand(key, patch="always")
        t0 = time.perf_counter()
        plan, dev = op._patch_for(False) if key == "sym" else op._patch_for()
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        b = plan.buckets[0]
        tiles = dev[0].tiles
        live = patch_spmv1.live_tile_bytes(tiles)
        print(f"  {label}: constructor {t_ctor:.2f} s; patch plan {b.nb} "
              f"slots of {b.MP}x{b.KP} (G={b.G}), "
              f"{plan.value_bytes / 1e6:.1f} MB, of which B7 reads "
              f"{live / 1e6:.1f} MB: {tiles.shape[0]} of "
              f"{b.nb * b.MP // 8} row tiles live, "
              f"{float(tiles[:, 1].double().mean()) * CC:.0f} of {b.KP} "
              f"columns wide on average; {t_plan:.2f} s on the host")
        mode = "m" if key == "sym" else "f"
        print(f"  {label}: {b7_launch_text(dev[0], mode)}")
        x = real_x(key)
        n = op.shape[0]
        launched = 0
        for tr in ((False, True) if key == "bsm" else (False,)):
            name = f"{label}: {'A.T @ x' if tr else 'A @ x'}"
            reset_counts()
            y = (op.T if tr else op) @ x
            torch.cuda.synchronize()
            got = counts()
            print(f"  {name}: launches {got}")
            require_counts(name, got, {"B7": 1, "B1": 0, "B2": 0, "B3": 0,
                                       "B5": 0, "B8": 0, "B10": 0})
            launched += got["B7"]
            errs["B7 float64"] = max(errs["B7 float64"], rel_check(
                f"{name} (B7) vs float64 bucket route", y,
                float64_reference(op, x, tr), TOL32))
            errs["B7"] = max(errs["B7"], rel_check(
                f"{name} (B7) vs its plain version", y,
                patch_engine.patch_spmv_plain(plan, dev, x, transpose=tr),
                TOL32))
            vals, cc, rs, mk = dev[0]
            other = (patch_engine.bucket_spmm_sym(
                vals, cc, rs, mk, x[:, None], owners=dev[0].owners[False])
                     if key == "sym" else patch_engine.bucket_spmm(
                         vals, cc, rs, x[:, None], n, transpose=tr))
            errs["B7 duality"] = max(errs["B7 duality"], rel_check(
                f"{name}: B7 vs {'B3' if key == 'sym' else 'B2'} at r=1",
                y, other[:, 0], TOL32))
            if not tr:
                y0 = y
        out["launches"][key] = launched
        flops = 2 * op.nnz
        times = dict(zip(("ms", "plain_ms", "graph_ms", "plain_graph_ms"),
                         time_routes(f"{label} SpMV, patch route (B7)",
                                     lambda: op @ x,
                                     lambda: patch_engine.patch_spmv_plain(
                                         plan, dev, x),
                                     live, flops, card)))
        times["b5_ms"], times["b5_graph_ms"] = default_beside(
            label, defaults[key], x, card)
        csr = csr_on_card([op])
        out["library"][key] = library_ms(f"{label} SpMV, torch.mv on the "
                                         f"CSR matrix", lambda: torch.mv(
                                             csr, x), y0, card)
        del csr
        times["bound"] = bound(logical_nnz(op) * 4 + 2 * n * 4, flops)
        times["plan_mb"], times["plan_s"] = plan.value_bytes / 1e6, t_plan
        times["read_mb"] = live / 1e6
        if key == "bsm":  # A.T @ x: B7 in mode t
            t_ms = time_routes(
                f"{label} A.T @ x, patch route (B7 mode t)",
                lambda: op.T @ x,
                lambda: patch_engine.patch_spmv_plain(plan, dev, x,
                                                      transpose=True),
                live, flops, card)
            times.update(t_ms=t_ms[0], t_plain_ms=t_ms[1],
                         t_graph_ms=t_ms[2], t_plain_graph_ms=t_ms[3])
        out["times"][key] = times
        del op, plan, dev
    return out


def phase11(card: str, defaults: dict, library: dict):
    print("phase 11: the panel v2 route (B10), panel='v2', on the operands "
          "of phases 3, 5 and 7")
    out = {"errs": {"B10": 0.0, "B10 duality": 0.0, "B10 float64": 0.0},
           "launches": {}, "mirror": {}, "times": {}}
    errs = out["errs"]
    for key, label in REAL.items():
        op, t_ctor = real_operand(key, panel="v2")
        print(f"  {label}: constructor {t_ctor:.2f} s")
        setup = stream_setup(op)
        require(stream_kernel(op) == "B10",
                f"{label}: the v2 panel plan must take the stream route")
        _, plan, dev = op._stream_entry(False)
        require(plan.mirror == (key == "sym"),
                f"{label}: mirror plan {plan.mirror}, expected "
                f"{key == 'sym'} (the fused plan on the symmetric operand)")
        x = real_x(key)
        reset_counts()
        y = op @ x
        torch.cuda.synchronize()
        got = counts()
        print(f"  {label}: A @ x launches {got}")
        require_counts(f"{label}: A @ x", got, dict(stream_want(op), B2=0,
                                                     B3=0))
        out["launches"][key] = got["B10"]
        out["mirror"][key] = got["B10 mirror"]
        errs["B10 float64"] = max(errs["B10 float64"], rel_check(
            f"{label}: A @ x (B10) vs float64 bucket route", y,
            float64_reference(op, x), TOL32))
        print(f"  {label}: {describe(plan)}; {b10_launch_text(plan)}")
        check_b10(label, plan, dev, x, errs)
        flops = 2 * op.nnz
        times = dict(zip(("ms", "plain_ms", "graph_ms", "plain_graph_ms"),
                         time_routes(f"{label} SpMV, panel v2 route (B10)",
                                     lambda: op @ x,
                                     lambda: panel2_spmv.panel2_apply_plain(
                                         plan, dev, x),
                                     stream_bytes(op), flops, card)))
        times["b5_ms"], times["b5_graph_ms"] = default_beside(
            label, defaults[key], x, card)
        times["library_ms"] = library[key]
        times["bound"] = bound(logical_nnz(op) * 4 + 2 * op.shape[0] * 4,
                               flops)
        times.update(seg=plan.seg, plan_mb=(plan.tile_bytes + plan.aux_bytes)
                     / 1e6, plan_s=setup["panel_s"],
                     read_mb=plan.nt * 4096 / 1e6,
                     geometry=panel2_spmv.panel2_geometry(plan))
        out["times"][key] = times
        del op, plan, dev

    # a batch of v2 operators loops: one B10 launch per product, no B6
    blocks, rs, cs = config3_blocks(4096)
    rng = np.random.default_rng(301)
    ops = [bt.VariableBlockCompressedRowStorage(
        [rng.standard_normal(b.shape).astype(np.float32) for b in blocks]
        if p else blocks, rs, cs, (4096, 4096), granularity=(8, 128),
        device=DEV, panel="v2") for p in range(2)]
    xs = torch.randn((2, 4096), generator=torch.Generator().manual_seed(24))
    reset_counts()
    y = bt.batched_mv(ops, xs.to(DEV))
    torch.cuda.synchronize()
    got = counts()
    print(f"  batched_mv of two v2 operators (config 3, n=4096): launches "
          f"{got}")
    require_counts("batched_mv of v2 operators", got,
                   {"B6": 0, "B5": 0, "B10": 2 * (stream_kernel(ops[0])
                                                  == "B10")})
    batch_check("batched_mv of v2 operators vs float64 scipy", y,
                scipy_refs(ops, xs))
    out["batched launches"] = got
    return out


BEM_NPTS, BEM_CLUSTERS, BEM_THRESH = 8192, 128, 0.6
# the diagonal self-term: examples/bem_solve.py's own, len(cluster) = 64
BEM_SELF_TERM = 64.0
SOLVE_TOL = 1e-5
# a self-term whose smallest eigenvalue lies near zero, printed beside the
# example's as the same spectrum shifted
NEAR_SINGULAR_SELF_TERM = 11.5
# the solves of n1 and n2 iterations whose difference times one iteration
# (tol = 0; GMRES: two and four restart cycles).  At tol = 0 BiCGStab
# reaches the f32 floor and stalls (rho or omega below its guard) after
# about 34 iterations on this system, so its solves stay below that
TIMED_ITERATIONS = {"cg": (16, 48), "bicgstab": (8, 24)}


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1 - 2 * (i + 0.5) / n
    rho = np.sqrt(1 - z * z)
    return np.stack([rho * np.cos(phi), rho * np.sin(phi), z], axis=1)


def bem_system(npts: int, nclusters: int, thresh: float, self_term: float,
               k: float = 0.0, dtype=np.float32, perm=None):
    """``examples/bem_solve.py``'s near-field system, as the arguments of a
    ``SymmetricBlockMatrix``: points on a Fibonacci sphere sorted by z,
    ``nclusters`` contiguous z-slice clusters, exp(i k r) / (4 pi r) blocks
    (k = 0: the example's 1/(4 pi r)) between clusters whose centres lie
    closer than ``thresh`` (each stored once), ``self_term`` on the
    diagonal; computed in complex128 and stored in ``dtype`` (its real part
    where ``dtype`` is real).  ``perm``: each point's index in a scattered
    numbering (the cluster index lists become scattered lists)."""
    pts = fibonacci_sphere(npts)
    pts = pts[np.argsort(pts[:, 2], kind="stable")]
    bounds = np.linspace(0, npts, nclusters + 1).astype(int)
    clusters = [np.arange(bounds[i], bounds[i + 1]) for i in range(nclusters)]
    centers = np.stack([pts[c].mean(axis=0) for c in clusters])
    real = not np.issubdtype(dtype, np.complexfloating)

    def kernel_block(ci, cj, diagonal):
        d = np.linalg.norm(pts[ci][:, None, :] - pts[cj][None, :, :], axis=-1)
        if diagonal:
            np.fill_diagonal(d, 1.0)  # replaced by the self-term below
        blk = np.exp(1j * k * d) / (4 * np.pi * np.maximum(d, 1e-9))
        if diagonal:
            blk[np.diag_indices_from(blk)] = self_term
        return (blk.real if real else blk).astype(dtype)

    name = (lambda idx: idx) if perm is None else (lambda idx: perm[idx])
    diagonals, offdiag, rows, cols = [], [], [], []
    for i in range(nclusters):
        diagonals.append(kernel_block(clusters[i], clusters[i], True))
        for j in range(i + 1, nclusters):
            if np.linalg.norm(centers[i] - centers[j]) < thresh:
                offdiag.append(kernel_block(clusters[i], clusters[j], False))
                rows.append(name(clusters[i]))
                cols.append(name(clusters[j]))
    return (diagonals, [name(c) for c in clusters], offdiag, rows, cols,
            (npts, npts))


def bem_dense(npts: int, nclusters: int, thresh: float, self_term: float,
              k: float = 0.0, dtype=np.float32) -> np.ndarray:
    """The same system assembled densely from the recipe alone, without the
    port and without the stored-once blocks: for each cluster, its rows
    against every point of each cluster whose centre lies closer than
    ``thresh`` (its own included), exp(i k r) / (4 pi r) rounded through
    ``dtype`` as the operator's values are, ``self_term`` on the diagonal;
    float64 where ``dtype`` is real, else complex128."""
    pts = fibonacci_sphere(npts)
    pts = pts[np.argsort(pts[:, 2], kind="stable")]
    bounds = np.linspace(0, npts, nclusters + 1).astype(int)
    label = np.repeat(np.arange(nclusters), np.diff(bounds))
    centers = np.stack([pts[label == c].mean(axis=0) for c in range(nclusters)])
    near = np.linalg.norm(centers[:, None] - centers[None], axis=-1) < thresh
    real = not np.issubdtype(dtype, np.complexfloating)
    A = np.zeros((npts, npts), dtype=np.float64 if real else np.complex128)
    for c in range(nclusters):
        rows = np.arange(bounds[c], bounds[c + 1])
        cols = np.flatnonzero(near[c][label])
        d = np.linalg.norm(pts[rows][:, None, :] - pts[cols][None, :, :],
                           axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            blk = np.exp(1j * k * d) / (4 * np.pi * d)
        A[np.ix_(rows, cols)] = (blk.real if real else blk).astype(dtype)
    A[np.diag_indices(npts)] = self_term
    return A


def product_want(op, k: int) -> dict:
    """Exact launches of k r = 1 products of ``op`` on its default route:
    its stream kernel (B5 / B8 / B10, mirror launches counted) where the
    stream route takes it, else the bucket route's launches."""
    if op.dtype == torch.float32 and stream_kernel(op) != "B1":
        name, plan = stream_kernel(op), op._stream_entry(False)[1]
        return {name: k, f"{name} mirror": k * bool(plan.mirror)}
    return {key: k * v for key, v in bucket_want(op).items()}


def solve_products(name: str, k: int, restart: int) -> tuple:
    """(host reads, S products, M products) of a preconditioned solve that
    took k iterations under the default maxiter, as ``solvers`` runs it:
    CG and BiCGStab run whole chunks until the read that finds the flag
    down (max(1, ceil(k / CHUNK)) reads); CG makes one S and one M product
    per step, BiCGStab two of each, both one S product for the initial
    residual and one for the true residual, CG one M product for z0.
    GMRES reads at each cycle's chunk boundaries and at its end (the cycle
    of ``last`` iterations reads ceil(last / CHUNK) times and runs
    min(CHUNK ceil(last / CHUNK), restart) steps of one S and one M
    product), plus one S and one M product per cycle for its residual, one
    M product for M b and one S product for the true residual."""
    C = solvers.CHUNK
    if name in ("cg", "bicgstab"):
        reads = max(1, -(-k // C))
        per = 1 if name == "cg" else 2
        return reads, 2 + per * reads * C, (name == "cg") + per * reads * C
    cycles = max(1, -(-k // restart))
    lasts = [restart] * (cycles - 1) + [k - (cycles - 1) * restart]
    reads = sum(max(1, -(-last // C)) for last in lasts)
    steps = sum(min(C * max(1, -(-last // C)), restart) for last in lasts)
    return reads, cycles + steps + 1, 1 + cycles + steps


def merged(*wants) -> dict:
    """Every counter of ``counts()``: the sum of the ``wants``, else 0."""
    out = {k: 0 for k in counts()}
    for want in wants:
        for k, v in want.items():
            out[k] += v
    return out


def source_site(filename: str, lineno: int) -> str:
    """A source line as ``path:line``: relative to the checkout inside it,
    from the package directory on (``torch/...``) outside it."""
    path = os.path.abspath(filename)
    if path.startswith(ROOT + os.sep):
        return f"{os.path.relpath(path, ROOT)}:{lineno}"
    parts = path.split(os.sep)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "site-packages":
            return f"{'/'.join(parts[i + 1:])}:{lineno}"
    return f"{path}:{lineno}"


def sync_sites(fn) -> Counter:
    """Host synchronisations ``fn`` makes, by the source line that made
    them (``torch.cuda.set_sync_debug_mode("warn")``); a line outside the
    checkout also names the innermost line of the package (else of this
    script) that led there."""
    sites = Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = source_site(filename, lineno)
        if not site.startswith("blocksparse_tpu_torch"):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if f.filename.startswith(ROOT + os.sep)]
            ours = [f for f in stack if not f.filename.endswith(
                "chip_smoke.py")] or stack
            if ours:
                site += f" via {source_site(ours[-1].filename, ours[-1].lineno)}"
        sites[site] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def solve_ms_per_iteration(solve, n1: int, n2: int) -> float:
    """Eager ms per iteration: host clock around solves of n1 and n2
    iterations (tol = 0: none converges, and each must run all n), each
    ending in a synchronize, the lowest of three of each, differenced."""
    def wall(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, info = solve(n)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        require(int(info.iterations) == n, f"a timed solve of maxiter {n} "
                f"stopped after {int(info.iterations)} iterations")
        return wall_s
    solve(n1)  # warm
    lo = {n: min(wall(n) for _ in range(3)) for n in (n1, n2)}
    return (lo[n2] - lo[n1]) / (n2 - n1) * 1e3


def phase12(card: str) -> dict:
    print(f"phase 12: BEM solve (examples/bem_solve.py's recipe), n={BEM_NPTS},"
          f" {BEM_CLUSTERS} clusters of {BEM_NPTS // BEM_CLUSTERS}, thresh "
          f"{BEM_THRESH}, self-term {BEM_SELF_TERM}, f32, tol {SOLVE_TOL}")
    t_phase = time.perf_counter()
    setup = {}
    t = time.perf_counter()
    args = bem_system(BEM_NPTS, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM)
    setup["recipe"] = time.perf_counter() - t
    t = time.perf_counter()
    S = bt.SymmetricBlockMatrix(*args, device=DEV)
    torch.cuda.synchronize()
    setup["operator (layout, coloring)"] = time.perf_counter() - t
    b_np = np.random.default_rng(0).standard_normal(BEM_NPTS).astype(np.float32)
    b = torch.from_numpy(b_np).to(DEV)
    t = time.perf_counter()
    S @ b
    torch.cuda.synchronize()
    setup["plans (first product)"] = time.perf_counter() - t
    t = time.perf_counter()
    M = bt.block_jacobi(S)
    torch.cuda.synchronize()
    setup["block_jacobi"] = time.perf_counter() - t
    t = time.perf_counter()
    A64 = bem_dense(BEM_NPTS, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM)
    Minv64 = block_diag([np.linalg.inv(A64[np.ix_(c, c)]) for c in args[1]],
                        format="csr")
    setup["independent float64 assembly and block inverses"] = (
        time.perf_counter() - t)
    b64 = b_np.astype(np.float64)
    bnorm = float(np.linalg.norm(b64))
    print(f"  {S}; {S.noffdiagonals} off-diagonal blocks stored once, "
          f"{logical_nnz(S) * 4 / 1e6:.1f} MB of stored values; M: {M}")
    print(f"  S @ p: {stream_kernel(S)} on {describe(S._stream_entry(False)[1])}")
    print(f"  M @ r: {stream_kernel(M)}"
          + (f" on {describe(M._stream_entry(False)[1])}"
             if stream_kernel(M) != "B1" else " (bucket route)"))
    print("  set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in setup.items()))
    out = {"setup_s": setup, "solves": {}, "launches": {}}

    # the spectrum of the independent assembly, on the card in float64; a
    # self-term s shifts it by s - BEM_SELF_TERM
    t = time.perf_counter()
    ev = torch.linalg.eigvalsh(torch.from_numpy(A64).to(DEV))
    lo, hi = float(ev[0]), float(ev[-1])
    del ev
    out["eigenvalues"] = {"min": lo, "max": hi, "self_term": BEM_SELF_TERM,
                          "seconds": time.perf_counter() - t}
    shift = BEM_SELF_TERM - NEAR_SINGULAR_SELF_TERM
    print(f"  independent float64 assembly: eigenvalues {lo:.6f} .. {hi:.6f} "
          f"at self-term {BEM_SELF_TERM} (condition {hi / lo:.2f}); "
          f"{lo - shift:.6f} .. {hi - shift:.6f} at self-term "
          f"{NEAR_SINGULAR_SELF_TERM}; eigvalsh on the card "
          f"{out['eigenvalues']['seconds']:.2f} s")
    require(lo > 0, f"the BEM system is not positive definite: {lo:.3e}")
    sp_iters = [0]
    x_sp, code = spla.cg(A64, b64, rtol=SOLVE_TOL, atol=0.0,
                         callback=lambda _x: sp_iters.__setitem__(
                             0, sp_iters[0] + 1))
    out["scipy_plain_cg"] = {"iterations": sp_iters[0], "code": code}
    print(f"  scipy.sparse.linalg.cg on it in float64, plain, tol "
          f"{SOLVE_TOL}: {sp_iters[0]} iterations, code {code}, residual "
          f"{np.linalg.norm(b64 - A64 @ x_sp) / bnorm:.3e} |b|")

    # each solve from a zero x0, counters reset just before it
    restart = inspect.signature(bt.gmres).parameters["restart"].default
    cases = (("cg", None), ("cg", M), ("bicgstab", M), ("gmres", M))

    def solve(name, m, **kw):
        return getattr(bt, name)(S, b, M=m, **kw)

    for name, m in cases:
        label = f"{name}{' + block_jacobi' if m is not None else ''}"
        reset_counts()
        solvers.HOST_CHECKS = 0
        t = time.perf_counter()
        x, info = solve(name, m, tol=SOLVE_TOL)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        got, reads = counts(), solvers.HOST_CHECKS
        k = int(info.iterations)
        require(info.iterations.device == DEV and info.residual.device == DEV,
                f"{label}: SolveInfo off the card")
        require(bool(info.converged), f"{label}: not converged in {k} "
                f"iterations, residual {float(info.residual):.3e}")
        r64 = b64 - A64 @ x.double().cpu().numpy()
        res64 = float(np.linalg.norm(r64))
        # GMRES meets tol on the preconditioned residual M (b - A x)
        held, limit, what = res64, 2 * SOLVE_TOL * bnorm, "2 tol |b|"
        if name == "gmres":
            held = float(np.linalg.norm(Minv64 @ r64))
            limit = 2 * SOLVE_TOL * float(np.linalg.norm(Minv64 @ b64))
            what = "2 tol |M b|, preconditioned"
        require(held <= limit, f"{label}: float64 residual {held:.3e} above "
                f"{limit:.3e} ({what})")
        want_reads, nS, nM = solve_products(name, k, restart)
        if m is None:
            nM = 0
        want = merged(product_want(S, nS), product_want(M, nM))
        require(reads == want_reads, f"{label}: {reads} host reads, expected "
                f"{want_reads} for {k} iterations")
        require(got == want, f"{label}: launches {got}, expected {want} "
                f"({nS} S and {nM} M products)")
        print(f"  {label}: {k} iterations, converged, residual on the card "
              f"{float(info.residual):.3e}, float64 residual {res64:.3e}"
              + (f", preconditioned {held:.3e}" if name == "gmres" else "")
              + f" <= {limit:.3e} ({what}); {reads} host reads "
              f"(HOST_CHECKS), {nS} S + {nM} M products, launches "
              f"{ {k_: v for k_, v in got.items() if v} }; {wall_s:.3f} s wall")
        out["solves"][label] = {"iterations": k, "host_checks": reads,
                                "residual64": res64, "wall_s": wall_s,
                                "products": (nS, nM)}
        if (name, m) == ("cg", M):
            out["launches"] = got

    # float64 on the card against scipy's CG on the independent assembly
    t = time.perf_counter()
    S64 = bt.SymmetricBlockMatrix(
        [a.astype(np.float64) for a in args[0]], args[1],
        [a.astype(np.float64) for a in args[2]], args[3], args[4], args[5],
        device=DEV)
    M64 = bt.block_jacobi(S64)
    setup["float64 operator and block_jacobi"] = time.perf_counter() - t
    b64_dev = torch.from_numpy(b64).to(DEV)
    gap = float(np.abs((S64 @ b64_dev).cpu().numpy() - A64 @ b64).max())
    require(gap <= TOL[torch.float64] * float(np.abs(A64 @ b64).max()),
            f"the port's float64 operator is {gap:.3e} off the independent "
            f"assembly")
    print(f"  the port's float64 operator against the independent assembly: "
          f"max |S x - A x| {gap:.3e}")
    reset_counts()
    x64, info64 = bt.cg(S64, b64_dev, tol=1e-10, M=M64)
    torch.cuda.synchronize()
    got64 = counts()
    k64 = int(info64.iterations)
    _, nS, nM = solve_products("cg", k64, restart)
    require(got64 == merged(product_want(S64, nS), product_want(M64, nM)),
            f"float64 cg + block_jacobi: launches {got64}, expected "
            f"{nS} S and {nM} M products on the bucket route")
    sp_iters = [0]
    x_sp, code = spla.cg(A64, b64, rtol=1e-10, atol=0.0, M=Minv64,
                         callback=lambda _x: sp_iters.__setitem__(
                             0, sp_iters[0] + 1))
    x64h = x64.cpu().numpy()
    rel64 = float(np.linalg.norm(x64h - x_sp) / np.linalg.norm(x_sp))
    require(code == 0 and bool(info64.converged),
            f"float64 cg: scipy code {code}, port converged "
            f"{bool(info64.converged)}")
    require(abs(k64 - sp_iters[0]) <= 1, f"float64 cg: {k64} iterations, "
            f"scipy {sp_iters[0]}")
    require(rel64 <= 1e-8, f"float64 cg: x {rel64:.3e} from scipy's")
    print(f"  float64 cg + block_jacobi at tol 1e-10: {k64} iterations on the "
          f"card, scipy.sparse.linalg.cg {sp_iters[0]}; |x - x_scipy| / "
          f"|x_scipy| {rel64:.3e}; launches "
          f"{ {k_: v for k_, v in got64.items() if v} }")
    out["float64"] = {"iterations": k64, "scipy_iterations": sp_iters[0],
                      "x_rel": rel64}
    del S64, M64, x64

    # host synchronisations: one chunk of each solver, and one read
    solver_file = source_site(solvers.__file__, 0).rsplit(":", 1)[0]
    src, first = inspect.getsourcelines(solvers._host_read)
    read_sites = {f"{solver_file}:{first + i}" for i in range(len(src))}
    out["syncs"] = {}
    for name in ("cg", "bicgstab", "gmres"):
        warm = sync_sites(lambda: solve(name, M, tol=0.0, maxiter=1))
        print(f"  host syncs, {name} + block_jacobi, a warm-up call of one "
              f"iteration: {dict(warm) or 'none'}")
        for n_it in (solvers.CHUNK, 2 * solvers.CHUNK):
            solvers.HOST_CHECKS = 0
            sites = sync_sites(lambda: solve(name, M, tol=0.0, maxiter=n_it))
            own = {s: c for s, c in sites.items() if s.startswith(solver_file)}
            others = {s: c for s, c in sites.items() if s not in own}
            require(set(own) <= read_sites and bool(own) == bool(
                solvers.HOST_CHECKS), f"{name}, {n_it} iterations: the "
                f"solver synchronised at {own}, {solvers.HOST_CHECKS} host "
                f"reads (its reads are {sorted(read_sites)})")
            print(f"  host syncs, {name} + block_jacobi, {n_it} iterations: "
                  f"{solvers.HOST_CHECKS} host reads, solver syncs {own}, "
                  f"elsewhere {others or 'none'}")
            out["syncs"][f"{name} {n_it}"] = {"reads": solvers.HOST_CHECKS,
                                              "solver": own, "other": others}

    # time: eager per iteration, the products' CUDA-graph floor
    p = torch.randn(BEM_NPTS, generator=torch.Generator().manual_seed(12)).to(DEV)
    floor_ms = graph_ms(lambda: M @ (S @ p))
    s_ms = graph_ms(lambda: S @ p)
    s_bound, m_bound = product_bound(S)[0], product_bound(M)[0]
    print(f"  one S and one M product replayed from a CUDA graph: "
          f"{floor_ms:.4f} ms (S alone {s_ms:.4f}); bound {s_bound + m_bound:.4f}"
          f" ms (S {s_bound:.4f}, M {m_bound:.4f}) [{card}]")
    out["floor_ms"], out["s_graph_ms"] = floor_ms, s_ms
    out["r1 bodies"] = r1_compare("the solve's M @ p (block_jacobi)",
                                  op_tables(M), p, card)
    # the products' floor with M's launch on each r = 1 body, in turns
    m_tables = op_tables(M)
    floors = [graph_ms(lambda body=body: body_into(
                  m_tables, S @ p, torch.zeros_like(p), body))
              for body in ("rows", "tile", "rows", "tile")]
    out["floor_rows_ms"], out["floor_tile_ms"] = (min(floors[0::2]),
                                                  min(floors[1::2]))
    print(f"  one S and one M product replayed, M on the row-stream body "
          f"{floors[0]:.4f} / {floors[2]:.4f} ms, on the tile core "
          f"{floors[1]:.4f} / {floors[3]:.4f} ms [{card}]")
    out["bound_ms"] = {"S": s_bound, "M": m_bound}
    per_iteration = {"cg": 1, "bicgstab": 2, "gmres": 1}
    out["per_iteration"] = {}
    for name, m in cases:
        label = f"{name}{' + block_jacobi' if m is not None else ''}"
        n1, n2 = TIMED_ITERATIONS.get(name, (2 * restart, 4 * restart))
        ms = solve_ms_per_iteration(
            lambda n, name=name, m=m: solve(name, m, tol=0.0, maxiter=n),
            n1, n2)
        floor = per_iteration[name] * (floor_ms if m is not None else s_ms)
        # a chunk with no read captures whole where nothing in it syncs
        # (GMRES reads inside every cycle)
        whole = gap = None
        if name != "gmres" and not any(out["syncs"][f"{name} {solvers.CHUNK}"][
                key] for key in ("solver", "other")):
            graph, gap, _ = replayed(lambda name=name, m=m: solve(
                name, m, tol=0.0, maxiter=solvers.CHUNK)[0])
            require(gap <= TOL32, f"{label}: a chunk replayed from a CUDA "
                    f"graph is {gap:.3e} off an eager one (limit {TOL32:.0e})")
            whole = median_ms(graph.replay) / solvers.CHUNK
            del graph
        low = per_iteration[name] * (s_bound + (m_bound if m is not None else 0))
        out["per_iteration"][label] = {"eager_ms": ms, "floor_ms": floor,
                                       "bound_ms": low, "share": floor / ms,
                                       "whole_graph_ms": whole,
                                       "replay_gap": gap}
        whole_txt = ("not captured" if whole is None else
                     f"{whole:.4f} ms (share {whole / ms:.2f}; replay "
                     f"{gap:.3e} off eager, limit {TOL32:.0e})")
        print(f"  {label}: eager {ms:.4f} ms per iteration; its products "
              f"replayed {floor:.4f} ms = {floor / ms:.2f} of it (device idle "
              f"share at most {1 - floor / ms:.2f}); bound of its products "
              f"{low:.4f} ms; a whole chunk replayed from a CUDA graph, per "
              f"iteration: {whole_txt} [{card}]")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 12 set-up: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in setup.items())
          + f"; phase {out['seconds']:.1f} s")
    return out


# -- phase 13: a complex Helmholtz BEM solve ----------------------------------

HELMHOLTZ_K = 16.0  # wavenumber of the exp(i k r) / (4 pi r) kernel
COMPLEX_RESTART = 20
COMPLEX_KINDS = {"S @ x": {}, "S.T @ x": {"transpose": True},
                 "S.H @ x": {"transpose": True, "conj": True},
                 "S.conj() @ x": {"conj": True}}


def complex_csr_on_card(op) -> torch.Tensor:
    """``op`` (a symmetric one expanded) as one CSR tensor of its own dtype
    on the card, duplicates summed: the library call's operand."""
    r, c, v = bt.rowcolvals(op)
    np_dt = torch.empty(0, dtype=op.dtype).numpy().dtype
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.from_numpy(r), torch.from_numpy(c)]).to(DEV),
        torch.from_numpy(np.asarray(v, np_dt)).to(DEV), op.shape).coalesce()
    return coo.to_sparse_csr()


def sym_b1_tables(S) -> tuple:
    """A contiguous symmetric operator's two chunked tables: the diagonal
    layout's (forward) and the off-diagonal layout's (symmetric mode)."""
    return (bucket_tables(S._dbuckets, S._dlayout)["chunked"],
            bucket_tables(S._obuckets, S._olayout)["chunked"])


def tables_product(tables, v, instance: str) -> torch.Tensor:
    """One product through one instance of B1 driven directly on
    ``tables``, (table, mode) pairs ("mma": the pair's tensor-core
    instance, "fma": the FMA tile core), one launch each that no counter
    sees."""
    out = torch.zeros_like(v)
    for table, mode in tables:
        if instance == "mma":
            fused_spmm._launch_mma(table, v, out, mode)
        else:
            fused_spmm.launch_table("bst_fused_spmm_multi", table, v, out,
                                    mode)
    return out


def b1_instance_product(S, v, instance: str) -> torch.Tensor:
    """``S @ v`` through one instance of B1 driven directly on ``S``'s two
    chunked tables (``tables_product``)."""
    return tables_product(zip(sym_b1_tables(S), (0, 2)), v, instance)


def op_tables(op) -> list:
    """``op``'s bucket-route passes of a forward product as (table, mode,
    kind) triples: a symmetric operator's diagonal layout forward and its
    off-diagonal one in the symmetric mode, any other's one layout forward;
    kind "B1" for its chunked buckets, "B9" for its element buckets."""
    parts = ([(op._dbuckets, op._dlayout, 0), (op._obuckets, op._olayout, 2)]
             if hasattr(op, "_dlayout") else [(op._buckets, op.layout, 0)])
    out = []
    for staged, layout, mode in parts:
        tabs = bucket_tables(staged, layout)
        for key, kind in (("chunked", "B1"), ("element", "B9")):
            if tabs[key] is not None:
                out.append((tabs[key], mode, kind))
    return out


def body_into(tables, v, out, body: str) -> torch.Tensor:
    """``out`` plus one product through one r = 1 body ("rows": the
    row-stream body; "tile": the tile core) driven directly on ``tables``
    (``op_tables``' triples), one launch each that no counter sees."""
    rows = body == "rows"
    for table, mode, kind in tables:
        fused_spmm.launch_table(fused_spmm.FMA_PREFIXES[kind][rows], table,
                                v, out, mode, rows=rows)
    return out


def r1_compare(label, tables, v, card) -> dict:
    """Both r = 1 bodies on ``tables`` with the operand ``v``, each product
    held to the other: eager ms, and graph ms in turns (rows, tile, rows,
    tile); the parts of the row-stream body's product: the zero fill of y
    alone and the launches into a standing output; printed beside the
    pair's rule (``fused_spmm.R1_RULES``)."""
    stored = tables[0][0].dtype
    rows = (lambda: body_into(tables, v, torch.zeros_like(v), "rows"))
    tile = (lambda: body_into(tables, v, torch.zeros_like(v), "tile"))
    rel_check(f"{label}: the row-stream body vs the tile core", rows(), tile(),
              TOL[v.dtype])
    r1, t1, r2, t2 = (graph_ms(f) for f in (rows, tile, rows, tile))
    standing = torch.zeros_like(v)
    res = {"rows_graph_ms": min(r1, r2), "tile_graph_ms": min(t1, t2),
           "rows_ms": median_ms(rows), "tile_ms": median_ms(tile),
           "fill_graph_ms": graph_ms(lambda: torch.zeros_like(v)),
           "rows_launch_graph_ms": graph_ms(
               lambda: body_into(tables, v, standing, "rows")),
           "rule": {kind: fused_spmm.r1_body(kind, stored, v.dtype)
                    for _t, _m, kind in tables}}
    print(f"  r = 1 bodies, {label} ({pair_name(stored, v.dtype)}, "
          f"{len(tables)} launches): row-stream graph {r1:.4f} / {r2:.4f}, "
          f"eager {res['rows_ms']:.4f} ms; tile core graph {t1:.4f} / "
          f"{t2:.4f}, eager {res['tile_ms']:.4f} ms; row-stream parts: "
          f"zero fill {res['fill_graph_ms']:.4f}, launches alone "
          f"{res['rows_launch_graph_ms']:.4f} ms; the rule picks "
          + ", ".join(f"{k} {b}" for k, b in res["rule"].items())
          + f" [{card}]")
    return res


def mma_tables(S, compute, r: int) -> int:
    """How many of ``S``'s two chunked tables the rule sends to the
    tensor-core instance of their values and ``compute`` at r columns
    (each table by its own deepest block)."""
    return sum(fused_spmm.b1_instance(t.dtype, compute, r, t.depth) == "mma"
               for t in sym_b1_tables(S))


def mma_plain_sym(S, v) -> torch.Tensor:
    """``S @ v`` through the tensor-core instances' plain version on ``S``'s
    two chunked tables."""
    out = torch.zeros_like(v)
    for table, sym in zip(sym_b1_tables(S), (False, True)):
        fused_spmm.mma_apply_plain(table, v, out=out, symmetric=sym)
    return out


# r of the instance scans that put B1's two instances of a pair side by side
MMA_SCAN_R = (2, 4, 8, 16, 32, 64)


def instance_scan(label, tables, dtype, n, card, rs=MMA_SCAN_R) -> dict:
    """Graph ms of B1's tensor-core and FMA instances on ``tables`` ((table,
    mode) pairs: one product) with a random [n, r] operand of ``dtype`` at
    each r of ``rs``, in turns (tensor cores, FMA, tensor cores, FMA), and
    ``takes``: the least r of the scan from which the tensor cores win at
    every larger r (None where they lose at its last), printed beside the
    rule's least r."""
    gen = torch.Generator().manual_seed(18)
    tables = list(tables)
    scan = {}
    for r in rs:
        v = torch.randn((n, r), generator=gen, dtype=dtype).to(DEV)
        m1, f1, m2, f2 = (graph_ms(lambda v=v, k=k: tables_product(
            tables, v, k)) for k in ("mma", "fma", "mma", "fma"))
        scan[r] = {"mma_graph_ms": min(m1, m2), "fma_graph_ms": min(f1, f2)}
    takes = min((r for r in rs
                 if all(scan[q]["mma_graph_ms"] < scan[q]["fma_graph_ms"]
                        for q in rs if q >= r)), default=None)
    rule = fused_spmm.MMA_RULES[(tables[0][0].dtype, dtype)]
    print(f"  B1's {label} instances, graph ms (tensor cores / FMA): "
          + ", ".join(f"r={r} {t['mma_graph_ms']:.4f} / "
                      f"{t['fma_graph_ms']:.4f}" for r, t in scan.items())
          + f"; the tensor cores win from r = {takes} of the scan on; the "
          f"rule's least r {rule.min_r} [{card}]")
    return {"scan": scan, "takes": takes, "min_r": rule.min_r}


def c128_spmm(S, A128, gen, card) -> dict:
    """The complex128 BEM's ``S @ x`` (r = 1: both r = 1 bodies timed) and
    ``S @ X`` at r = 16 and 64 (B1's complex128 tensor-core instance where
    the rule says) against the complex128 assembly, exact launches by entry
    point, timed eager and from a CUDA graph beside the FMA instance on the
    same tables, a complex128 CSR call and the bound; both instances
    scanned over r."""
    c128 = torch.complex128
    n = S.shape[0]
    A = torch.from_numpy(A128).to(DEV)
    res = {"errs": {}, "times": {}, "launches": 0}
    csr = complex_csr_on_card(S)
    for label, r in (("S @ x", 1), ("S @ X r=16", 16), ("S @ X", 64)):
        v = torch.randn((n, r) if r > 1 else (n,), generator=gen,
                        dtype=c128).to(DEV)
        k = mma_tables(S, c128, r)
        mma = k == 2
        reset_counts()
        Y = S @ v
        torch.cuda.synchronize()
        want = merged({"B1": 2, "B1 sym": 1, "B1 mma": k})
        want_e = entries((fused_spmm.MMA_RULES[(c128, c128)].entry, k),
                         (fma_entry("B1", c128, c128, r), 2 - k))
        require(counts() == want and entry_counts() == want_e,
                f"complex128 {label}: launches {counts()}, {entry_counts()}")
        res["launches"] += counts()["B1 mma"]
        res["errs"][label] = rel_check(
            f"complex128 {label} vs the complex128 assembly", Y, A @ v,
            TOL[c128])
        fma = (lambda v=v: b1_instance_product(S, v, "fma"))
        rel_check(f"complex128 {label}: the FMA instance vs the product", fma(),
                  Y, TOL[c128])
        t = timed(f"complex128 {label} (2 B1{' on the tensor cores' if mma else ''})",
                  lambda v=v: S @ v,
                  (lambda v=v: mma_plain_sym(S, v)) if mma
                  else (lambda v=v: plain_buckets_sym(S, v)),
                  product_bound(S, r), card)
        lib = library_ms(f"complex128 {label}: complex128 CSR "
                         f"(torch.sparse)", lambda v=v: csr @ v, Y, card)
        t["library_ms"], t["library_graph_ms"] = lib, lib.graph
        if r == 1:
            t["r1"] = r1_compare("complex128 BEM S @ x", op_tables(S), v, card)
        else:
            t["fma_ms"], t["fma_graph_ms"] = median_ms(fma), graph_ms(fma)
            print(f"  complex128 {label}: the FMA instance on the same tables"
                  f" eager {t['fma_ms']:.4f}, graph {t['fma_graph_ms']:.4f} "
                  f"ms [{card}]")
        res["times"][label] = t
    del csr, A
    res["scan"] = instance_scan("complex128", zip(sym_b1_tables(S), (0, 2)),
                                c128, n, card)
    return res


def phase13(card: str) -> dict:
    n, ncl, thresh = BEM_NPTS, BEM_CLUSTERS, BEM_THRESH
    k, st = HELMHOLTZ_K, BEM_SELF_TERM
    print(f"phase 13: complex Helmholtz BEM (exp(i k r) / (4 pi r), k={k}), "
          f"n={n}, {ncl} clusters of {n // ncl}, thresh {thresh}, self-term "
          f"{st}, complex64 / complex128")
    t_phase = time.perf_counter()
    setup, out = {}, {"launches": {}, "errs": {}, "times": {}}
    t = time.perf_counter()
    args = bem_system(n, ncl, thresh, st, k, np.complex64)
    setup["recipe"] = time.perf_counter() - t
    t = time.perf_counter()
    S = bt.SymmetricBlockMatrix(*args, device=DEV)
    torch.cuda.synchronize()
    setup["operator (layout, coloring)"] = time.perf_counter() - t
    t = time.perf_counter()
    A128 = bem_dense(n, ncl, thresh, st, k, np.complex128)
    setup["independent complex128 assembly"] = time.perf_counter() - t
    # the oracle of the complex64 products: the assembly rounded through
    # complex64, as the operator's values are, on the card in complex128
    A_dev = torch.from_numpy(A128).to(DEV).to(torch.complex64).to(
        torch.complex128)
    mb = logical_nnz(S) * 8 / 1e6
    print(f"  {S}; {S.ndiagonals} diagonal + {S.noffdiagonals} off-diagonal "
          f"blocks, {mb:.1f} MB of stored complex64 values")
    out["stored_mb"] = mb
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(n, generator=gen, dtype=torch.complex64).to(DEV)
    X = torch.randn((n, 64), generator=gen, dtype=torch.complex64).to(DEV)
    X16 = torch.randn((n, 16), generator=gen, dtype=torch.complex64).to(DEV)
    want = merged({"B1": 2, "B1 sym": 1})

    def want_r(r):  # r > 1: the tensor-core instance where the rule says
        return merged({"B1": 2, "B1 sym": 1,
                       "B1 mma": mma_tables(S, torch.complex64, r)})

    # 1. products against the oracle, exact launches
    refs = {"S @ x": A_dev, "S.T @ x": A_dev.T, "S.H @ x": A_dev.conj().T,
            "S.conj() @ x": A_dev.conj()}
    b1_total = rows_total = 0
    for label, kw in COMPLEX_KINDS.items():
        reset_counts()
        got = S.apply(x, **kw)
        torch.cuda.synchronize()
        require(counts() == want, f"{label}: launches {counts()}, expected "
                f"{ {k_: v for k_, v in want.items() if v} }")
        b1_total += counts()["B1"]
        rows_total += fused_spmm.ROW_LAUNCHES
        out["errs"][label] = rel_check(f"{label} (native) vs the independent "
                                       f"assembly", got, refs[label] @
                                       x.to(torch.complex128), TOL32)
    mma_total = 0
    for label, v in (("S @ X", X), ("S @ X r=16", X16)):
        reset_counts()
        Y = S @ v
        torch.cuda.synchronize()
        want_v = want_r(v.shape[1])
        require(counts() == want_v, f"{label}: launches {counts()}, expected "
                f"{ {k_: c for k_, c in want_v.items() if c} }")
        b1_total += counts()["B1"]
        mma_total += counts()["B1 mma"]
        out["errs"][label] = rel_check(
            f"{label} (native, r={v.shape[1]}) vs the independent assembly",
            Y, A_dev @ v.to(torch.complex128), TOL32)
    out["launches"]["native"] = b1_total
    out["launches"]["mma"] = mma_total
    print(f"  each native product: launches "
          f"{ {k_: v for k_, v in want.items() if v} } at r = 1, "
          f"{ {k_: v for k_, v in want_r(64).items() if v} } at r = 16 and 64 "
          f"(2 B1, one of them in the symmetric mode, r > 1 on the complex64 "
          f"tensor-core instance; no B2-B10)")

    # 2. the scattered variant: element buckets, B9's element pass
    perm = np.random.default_rng(14).permutation(n)
    t = time.perf_counter()
    Ss = bt.SymmetricBlockMatrix(
        *bem_system(n, ncl, thresh, st, k, np.complex64, perm=perm),
        device=DEV, schedule="serial")
    torch.cuda.synchronize()
    setup["scattered operator"] = time.perf_counter() - t
    require(all(b.chunk == 1 for lay in (Ss._dlayout, Ss._olayout)
                for b in lay.buckets), "the scattered variant must have "
            "element buckets only")
    xs = torch.empty_like(x)
    xs[torch.from_numpy(perm).to(DEV)] = x  # the same x, renumbered
    want_s = merged({"B9 element": 2, "B9 element sym": 1})
    ip = torch.from_numpy(perm).to(DEV)
    b9_total = erows_total = 0
    for label, kw in COMPLEX_KINDS.items():
        reset_counts()
        got = Ss.apply(xs, **kw)[ip]
        torch.cuda.synchronize()
        require(counts() == want_s, f"scattered {label}: launches {counts()}")
        b9_total += counts()["B9 element"]
        erows_total += mask_select.ELEMENT_ROW_LAUNCHES
        out["errs"][f"scattered {label}"] = rel_check(
            f"scattered {label} (serial) vs the assembly", got,
            refs[label] @ x.to(torch.complex128), TOL32)
    out["launches"]["scattered"] = b9_total
    out["launches"]["rows"] = rows_total
    out["launches"]["element rows"] = erows_total
    print(f"  each scattered product: launches "
          f"{ {k_: v for k_, v in want_s.items() if v} }")
    del Ss

    # 3. times: native, the split form, the library call, the bound
    t = time.perf_counter()
    P = bt.split_complex(S)
    (P @ x, P @ X)  # the children's plans, built at their first products
    torch.cuda.synchronize()
    setup["split_complex and its plans"] = time.perf_counter() - t
    csr = complex_csr_on_card(S)
    for label, v, r in (("S @ x", x, 1), ("S @ X r=16", X16, 16),
                        ("S @ X", X, 64)):
        bnd = product_bound(S, r)
        native = (lambda v=v: S @ v)
        split = (lambda v=v: P @ v)
        reset_counts()
        ys = split()
        torch.cuda.synchronize()
        split_launches = {k_: c for k_, c in counts().items() if c}
        require(sum(split_launches.values()) > 0,
                f"split {label}: no launch")
        out["errs"][f"split {label}"] = rel_check(
            f"split {label} vs the assembly", ys,
            A_dev @ v.to(torch.complex128), TOL32)
        mma = r > 1 and mma_tables(S, v.dtype, r) == 2
        plain = ((lambda v=v: mma_plain_sym(S, v)) if mma
                 else (lambda v=v: plain_buckets_sym(S, v)))
        rel_check(f"{label}: the plain versions vs the kernels", plain(),
                  native(), TOL32)
        n1, s1, s2, n2 = (median_ms(native), median_ms(split),
                          median_ms(split), median_ms(native))
        ng, sg = graph_ms(native), graph_ms(split)
        pm, pg = median_ms(plain), graph_ms(plain)
        lib = library_ms(f"{label} complex64 CSR (torch.sparse)",
                         lambda v=v: csr @ v, native(), card)
        out["times"][label] = {
            "ms": min(n1, n2), "graph_ms": ng, "plain_ms": pm,
            "plain_graph_ms": pg, "split_ms": min(s1, s2),
            "split_graph_ms": sg, "split_launches": split_launches,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            "library_graph_ms": lib.graph}
        if mma:  # the FMA instance on the same tables, beside it
            fma = (lambda v=v: b1_instance_product(S, v, "fma"))
            rel_check(f"{label}: the FMA instance vs the tensor cores", fma(),
                      native(), TOL32)
            out["times"][label].update(fma_ms=median_ms(fma),
                                       fma_graph_ms=graph_ms(fma))
        print(f"  {label}: native (2 B1{', tensor cores' if mma else ''}) "
              f"eager {n1:.4f} / {n2:.4f} ms, graph "
              f"{ng:.4f} ms; split_complex (4 real products, {split_launches}) "
              f"eager {s1:.4f} / {s2:.4f} ms, graph {sg:.4f} ms; bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}) = {100 * bnd[0] / ng:.1f}% of the "
              f"native graph time; plain versions {pm:.4f} ms eager, "
              f"{pg:.4f} ms graph"
              + (f"; the FMA instance on the same tables eager "
                 f"{out['times'][label]['fma_ms']:.4f}, graph "
                 f"{out['times'][label]['fma_graph_ms']:.4f} ms" if mma
                 else "") + f" [{card}]")
    del csr
    out["times"]["S @ x"]["r1"] = r1_compare("complex64 BEM S @ x",
                                             op_tables(S), x, card)
    # where the tensor-core instance takes over: both instances on S's
    # tables at each r of the scan
    out["times"]["instance scan"] = instance_scan(
        "complex64", zip(sym_b1_tables(S), (0, 2)), torch.complex64, n, card)

    # 4. solves: GMRES(20) + block_jacobi in complex64, complex128 vs scipy
    t = time.perf_counter()
    M = bt.block_jacobi(S)
    torch.cuda.synchronize()
    setup["block_jacobi"] = time.perf_counter() - t
    require(M.dtype == torch.complex64, f"block_jacobi dtype {M.dtype}")
    Minv = block_diag([np.linalg.inv(A128[np.ix_(c, c)]) for c in args[1]],
                      format="csr")
    b = torch.randn(n, generator=gen, dtype=torch.complex64).to(DEV)
    b128 = b.cpu().numpy().astype(np.complex128)
    A64h = A128.astype(np.complex64).astype(np.complex128)
    reset_counts()
    solvers.HOST_CHECKS = 0
    t = time.perf_counter()
    xg, info = bt.gmres(S, b, M=M, tol=SOLVE_TOL, restart=COMPLEX_RESTART)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    got, reads, kit = counts(), solvers.HOST_CHECKS, int(info.iterations)
    require(bool(info.converged), f"complex64 gmres: not converged in {kit}")
    r64 = b128 - A64h @ xg.cpu().numpy().astype(np.complex128)
    held = float(np.linalg.norm(Minv @ r64))
    limit = 2 * SOLVE_TOL * float(np.linalg.norm(Minv @ b128))
    require(held <= limit, f"complex64 gmres: preconditioned residual "
            f"{held:.3e} above {limit:.3e}")
    want_reads, nS, nM = solve_products("gmres", kit, COMPLEX_RESTART)
    want_g = merged({"B1": 2 * nS + nM, "B1 sym": nS})
    require(got == want_g and reads == want_reads, f"complex64 gmres: "
            f"launches {got}, reads {reads}; expected {want_g}, {want_reads}")
    sp_it = [0]
    x_sp, code = spla.gmres(A64h, b128, rtol=SOLVE_TOL, atol=0.0,
                            restart=COMPLEX_RESTART, M=Minv,
                            callback=lambda _r: sp_it.__setitem__(
                                0, sp_it[0] + 1), callback_type="pr_norm")
    require(code == 0 and abs(kit - sp_it[0]) <= 3, f"complex64 gmres: "
            f"{kit} iterations, scipy {sp_it[0]} (code {code})")
    out["gmres64"] = {"iterations": kit, "scipy_iterations": sp_it[0],
                      "preconditioned_residual": held, "limit": limit,
                      "host_reads": reads, "wall_s": wall_s, "launches": got}
    print(f"  complex64 gmres({COMPLEX_RESTART}) + block_jacobi, tol "
          f"{SOLVE_TOL}: {kit} iterations (scipy.sparse.linalg.gmres on the "
          f"assembly with the same block inverses: {sp_it[0]}), preconditioned"
          f" residual {held:.3e} <= {limit:.3e}; {reads} host reads, launches "
          f"{ {k_: v for k_, v in got.items() if v} } ({nS} S + {nM} M "
          f"products); {wall_s:.3f} s wall")
    out["launches"]["gmres64"] = got["B1"]

    t = time.perf_counter()
    S128 = bt.SymmetricBlockMatrix(
        *bem_system(n, ncl, thresh, st, k, np.complex128), device=DEV)
    M128 = bt.block_jacobi(S128)
    torch.cuda.synchronize()
    setup["complex128 operator and block_jacobi"] = time.perf_counter() - t
    reset_counts()
    x128, info128 = bt.gmres(S128, b.to(torch.complex128), M=M128, tol=1e-12,
                             restart=COMPLEX_RESTART)
    torch.cuda.synchronize()
    k128 = int(info128.iterations)
    require(bool(info128.converged), f"complex128 gmres: not converged in "
            f"{k128}")
    sp_it = [0]
    x_sp, code = spla.gmres(A128, b128, rtol=1e-12, atol=0.0,
                            restart=COMPLEX_RESTART, M=Minv,
                            callback=lambda _r: sp_it.__setitem__(
                                0, sp_it[0] + 1), callback_type="pr_norm")
    rel128 = float(np.linalg.norm(x128.cpu().numpy() - x_sp)
                   / np.linalg.norm(x_sp))
    require(code == 0 and rel128 <= 1e-10, f"complex128 gmres: x {rel128:.3e}"
            f" from scipy's (code {code})")
    out["gmres128"] = {"iterations": k128, "scipy_iterations": sp_it[0],
                       "x_rel": rel128}
    print(f"  complex128 gmres({COMPLEX_RESTART}) + block_jacobi at tol 1e-12:"
          f" {k128} iterations, scipy {sp_it[0]}; |x - x_scipy| / |x_scipy| "
          f"{rel128:.3e}")
    del M128, A_dev
    # 5. complex128 S @ X on B1's f64 tensor-core instance
    out["c128"] = c128_spmm(S128, A128, gen, card)
    del S128

    # eager ms per GMRES iteration beside its products' graph floor
    p = torch.randn(n, generator=gen, dtype=torch.complex64).to(DEV)
    floor = graph_ms(lambda: M @ (S @ p))
    ms = solve_ms_per_iteration(
        lambda it: bt.gmres(S, b, M=M, tol=0.0, maxiter=it,
                            restart=COMPLEX_RESTART),
        2 * COMPLEX_RESTART, 4 * COMPLEX_RESTART)
    out["per_iteration"] = {"eager_ms": ms, "floor_ms": floor,
                            "share": floor / ms}
    print(f"  complex64 gmres + block_jacobi: eager {ms:.4f} ms per iteration;"
          f" one S and one M product replayed {floor:.4f} ms = "
          f"{floor / ms:.2f} of it [{card}]")
    out["setup_s"] = setup
    out["seconds"] = time.perf_counter() - t_phase
    print("  phase 13 set-up: " + ", ".join(f"{k_} {v:.2f} s"
                                            for k_, v in setup.items())
          + f"; phase {out['seconds']:.1f} s")
    return out


# -- phase 14: options, dtype rules and interop (--options) ---------------------

# the JAX package's sorted scatter: a segment sum in XLA (no Pallas kernel);
# B9's owner mode also takes the place of its scatter kernel
SORTED_REPLACES = "blocksparse_tpu/ops/xla_spmv.py:196"
# each instance's launches against their plain versions (phase 14's keys)
KERNEL_ERR = {"B1 bf16->f32": "bf16 B1", "B1 bf16->f64": "bf16 B1",
              "B9 element bf16->f32": "bf16 scattered B9 element",
              "B9 element bf16->f64": "bf16 scattered B9 element",
              "B1 f32->f64": "f32->f64 B1",
              "B9 element f32->f64": "f32->f64 scattered B9 element",
              "B1 c64->c128": "c64->c128 B1",
              "B9 element c64->c128": "c64->c128 scattered B9 element",
              "B9 owner": "B9 owner kernel"}


DT_NAME = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
           torch.complex128: "c128", torch.bfloat16: "bf16"}
# the owner mode's instances beside float32, as (stored, operand) dtypes:
# every pair of COMPUTE_TYPES
OWNER_PAIRS = ((torch.float32, torch.float64), (torch.float64, torch.float64),
               (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.float64),
               (torch.complex64, torch.complex64),
               (torch.complex64, torch.complex128),
               (torch.complex128, torch.complex128))


def pair_name(stored, operand) -> str:
    """"f64" for one type, "bf16->f32" for stored -> compute."""
    return (DT_NAME[stored] if stored == operand
            else f"{DT_NAME[stored]}->{DT_NAME[operand]}")


def dense_of(op, dtype) -> torch.Tensor:
    """``op``'s values (bf16 ones as their exact float32 copies) as a dense
    matrix of ``dtype`` on the card, duplicates summed."""
    r, c, v = bt.rowcolvals(op)
    d = torch.zeros(op.shape, dtype=dtype, device=DEV)
    d.index_put_((torch.from_numpy(r).to(DEV), torch.from_numpy(c).to(DEV)),
                 torch.from_numpy(np.ascontiguousarray(v)).to(DEV).to(dtype),
                 accumulate=True)
    return d


def entry_counts() -> dict:
    """B1's and B9's launches since the last reset, by entry point."""
    return {k: v for k, v in fused_spmm.ENTRY_LAUNCHES.items() if v}


def fma_entry(kind: str, stored, compute, r: int = 1) -> str:
    """The entry point a launch of B1 (``kind`` "B1") or of B9's element
    pass ("B9") off the tensor cores takes at r columns: the row-stream
    body at r = 1 where ``fused_spmm.r1_body`` says "rows", else the tile
    core."""
    return fused_spmm.fma_launch(kind, stored, compute, r)[0]


def entries(*named) -> dict:
    """``{entry: launches}`` of (entry, launches) pairs, summed, zeros
    dropped: the shape of ``entry_counts()``."""
    out = Counter()
    for name, k in named:
        out[name] += k
    return {k: v for k, v in out.items() if v}


def csr_of(op, dtype) -> torch.Tensor:
    """``op``'s values (a symmetric operator expanded, bf16 values as their
    exact float32 copies) as one CSR matrix of ``dtype`` on the card,
    duplicates summed: phase 14's reference and library-call operand."""
    r, c, v = bt.rowcolvals(op)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.from_numpy(r), torch.from_numpy(c)]).to(DEV),
        torch.from_numpy(np.ascontiguousarray(v)).to(DEV).to(dtype),
        op.shape).coalesce()
    return coo.to_sparse_csr()


def timed(label, fn, plain, bnd, card, plain_graph=True) -> dict:
    """Eager and CUDA-graph ms of ``fn``, its plain version's eager ms (and
    graph ms where ``plain_graph``), beside the bound; printed."""
    ms, gms = median_ms(fn), graph_ms(fn)
    pms = median_ms(plain)
    pgms = graph_ms(plain) if plain_graph else None
    pg_txt = f", graph {pgms:.4f}" if pgms is not None else ""
    print(f"  {label}: eager {ms:.4f} ms, graph {gms:.4f} ms; plain "
          f"{pms:.4f}{pg_txt} ms; bound {bnd[0]:.4g} ms ({bnd[1]}) = "
          f"{100 * bnd[0] / gms:.1f}% of the graph time [{card}]")
    return {"ms": ms, "graph_ms": gms, "plain_ms": pms,
            "plain_graph_ms": pgms, "bound": bnd}


def launch_vs_plain(label, table, launch, plain, xs, modes, tol,
                    conj=False) -> float:
    """One launch over ``table`` against its plain version on the same
    operands, in each of ``modes`` (keys of ``MODE_KW``; with ``conj``
    each also with the values conjugated), for each operand of ``xs`` (the
    output length is the operand's: square operators)."""
    err = 0.0
    for x in xs:
        for mode in modes:
            for cj in ((False, True) if conj else (False,)):
                kw = {**MODE_KW[mode], **({"conj": True} if cj else {})}
                got = launch(table, x, out=torch.zeros_like(x), **kw)
                ref = plain(table, x, out=torch.zeros_like(x), **kw)
                torch.cuda.synchronize()
                r = 1 if x.ndim == 1 else x.shape[1]
                err = max(err, rel_check(
                    f"{label} {mode}{' conj' if cj else ''} {x.dtype} r={r} "
                    f"vs its plain version", got, ref, tol))
    return err


def bucket_launch_check(label, op, xs, tol) -> dict:
    """``op``'s B1 and element-pass launches (its diagonal layout forward
    and transposed and its off-diagonal one in the symmetric mode, or its
    one layout forward and transposed) against their plain versions."""
    layouts = ([(op._dbuckets, op._dlayout, ("forward", "transpose")),
                (op._obuckets, op._olayout, ("symmetric",))]
               if hasattr(op, "_dlayout")
               else [(op._buckets, op.layout, ("forward", "transpose"))])
    errs = {"B1": 0.0, "B9 element": 0.0}
    for staged, layout, modes in layouts:
        tabs = bucket_tables(staged, layout)
        for key, name, launch, plain in (
                ("chunked", "B1", fused_spmm.multi_block_apply,
                 fused_spmm.multi_block_apply_plain),
                ("element", "B9 element", mask_select.element_apply,
                 mask_select.element_apply_plain)):
            if tabs[key] is not None:
                errs[name] = max(errs[name], launch_vs_plain(
                    f"{label} {name}", tabs[key], launch, plain, xs, modes,
                    tol))
    return errs


def scattered_copy(op, perm, blocks=None, **kw):
    """``op`` (a BSM) with every index renumbered through ``perm`` (and
    ``blocks`` in place of its blocks, where given)."""
    n = op.nblocks
    return bt.BlockSparseMatrix(
        blocks or [op.block(i) for i in range(n)],
        [perm[op.blockrowindices(i)] for i in range(n)],
        [perm[op.blockcolindices(i)] for i in range(n)], op.shape,
        device=DEV, **kw)


def instance_entry(name, src, replaces, launches, err, t, lib, card, timed_,
                   **extra) -> dict:
    """A kernel-summary entry of one stored / compute instance."""
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "graph_ms": t["graph_ms"],
            "plain_ms": t["plain_ms"], "plain_graph_ms": t["plain_graph_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": lib, "library_graph_ms": getattr(lib, "graph", None),
            "timed": timed_, "card": card, **extra}


def owner_instances(A, fperm, fxs, fXs, out, lib, card) -> list:
    """Every instance of B9's owner mode beside float32 (``OWNER_PAIRS``):
    the sorted flagship (``A`` renumbered through ``fperm``) stored in each
    dtype (complex: its blocks plus i times fresh ones), with each operand
    dtype that reaches the instance (``fxs`` / ``fXs``, complex ones made
    from them), through A @, A.T @ and, for complex values, A.H @ and
    A.conj() @: the kernel against its plain version, exact launches by
    entry point, each product twice bit-equal and against a dense
    reference, times and the library call into ``out`` / ``lib``; returns
    their keys."""
    times, errs, launches = out["times"], out["errs"], out["launches"]
    f64 = torch.float64
    irng = np.random.default_rng(16)
    imag = [irng.standard_normal(A.block(i).shape) for i in range(A.nblocks)]
    cxs = torch.complex(fxs, torch.roll(fxs, 1))
    cXs = torch.complex(fXs, torch.roll(fXs, 1, 0))
    keys = []
    for stored, operand in OWNER_PAIRS:
        key = f"B9 owner {pair_name(stored, operand)}"
        keys.append(key)
        blocks = ([(A.block(i) + 1j * imag[i]).astype(np.complex128)
                   for i in range(A.nblocks)] if stored.is_complex else None)
        Op = scattered_copy(A, fperm, blocks, scatter="sorted", dtype=stored)
        require(Op.dtype == stored, f"{key}: operator dtype {Op.dtype}")
        wide = torch.complex128 if stored.is_complex else f64
        D = dense_of(Op, wide)
        vx, vX = ((cxs, cXs) if operand.is_complex else (fxs, fXs))
        vx, vX = vx.to(operand), vX.to(operand)
        table = bucket_tables(Op._buckets, Op.layout)["element"]
        errs[f"{key} kernel"] = launch_vs_plain(
            f"B9 owner mode {pair_name(stored, operand)}", table,
            mask_select.owner_apply, mask_select.owner_apply_plain,
            (vx, vX), ("forward", "transpose"), TOL[operand],
            conj=stored.is_complex)
        prods = {"A @": (lambda v: Op @ v, D),
                 "A.T @": (lambda v: Op.T @ v, D.T)}
        if stored.is_complex:
            prods.update({"A.H @": (lambda v: Op.H @ v, D.conj().T),
                          "A.conj() @": (lambda v: Op.conj() @ v, D.conj())})
        reset_counts()
        got = {(lbl, r): (f(v), f(v)) for lbl, (f, _) in prods.items()
               for r, v in ((1, vx), (64, vX))}
        torch.cuda.synchronize()
        # two products per kind and r, each the two passes
        want_e = {fused_spmm.entry_point("bst_element_owner_products",
                                         stored, operand): 4 * len(prods),
                  fused_spmm.entry_point("bst_element_owner_sum",
                                         operand): 4 * len(prods)}
        want = sum(want_e.values())
        require(counts() == merged({"B9 owner": want}) and
                entry_counts() == want_e,
                f"{key} products: launches {counts()}, {entry_counts()} "
                f"(want {want_e})")
        launches[key] = want
        err = 0.0
        for (lbl, r), (p1, p2) in got.items():
            require(p1.dtype == operand, f"sorted {lbl} x ({key}): dtype "
                    f"{p1.dtype}, want {operand}")
            require(torch.equal(p1, p2), f"sorted {lbl} x ({key}) r={r}: "
                    f"two products are not bit-identical")
            v = vx if r == 1 else vX
            err = max(err, rel_check(
                f"sorted {lbl} x ({key}) r={r} vs its values dense in "
                f"{DT_NAME[wide]}", p1, prods[lbl][1] @ v.to(wide),
                TOL[operand]))
        errs[key] = err
        print(f"  {key}: launches {want_e} ({', '.join(prods)} at r = 1 and "
              f"64, each twice bit-identical)")
        times[key] = timed(
            f"sorted A @ x ({pair_name(stored, operand)}, B9 owner mode)",
            lambda: Op @ vx, lambda: mask_select.owner_apply_plain(
                table, vx, out=torch.zeros_like(vx)),
            product_bound(Op, 1, operand), card, plain_graph=False)
        lcsr = csr_of(Op, operand)
        lib[key] = library_ms(f"sorted A @ x ({pair_name(stored, operand)}): "
                              f"{DT_NAME[operand]} CSR (cuSPARSE)",
                              lambda: lcsr @ vx, got[("A @", 1)][0], card)
        del Op, D, table, got, lcsr
    return keys


def real_size_rule2(S32, args, perm, x, x64, renumbered, card) -> dict:
    """Phase 12's BEM operator (f32, n = 8192) with an f64 operand (B1 f32
    -> f64) and its scattered copy (schedule "serial") through its bucket
    route in f32 and with an f64 operand (B9's element pass f32 and f32 ->
    f64): exact launches by entry point, against float64 CSR products of
    the same values, timed beside a float32 / float64 CSR call."""
    f32, f64 = torch.float32, torch.float64
    out = {"times": {}, "lib": {}, "errs": {}, "launches": {}}
    n = S32.shape[0]
    Ss = bt.SymmetricBlockMatrix(*bem_system(n, BEM_CLUSTERS, BEM_THRESH,
                                             BEM_SELF_TERM, perm=perm),
                                 device=DEV, schedule="serial")
    require(all(b.chunk == 1 for lay in (Ss._dlayout, Ss._olayout)
                for b in lay.buckets), "the scattered BEM must have element "
            "buckets only")
    xs, xs64 = renumbered(x), renumbered(x64)
    ref64, refs64, refs32 = csr_of(S32, f64), csr_of(Ss, f64), csr_of(Ss, f32)
    # the BEM stored in float64 (its values computed in complex128, their
    # real parts kept in float64)
    S64 = bt.SymmetricBlockMatrix(*bem_system(n, BEM_CLUSTERS, BEM_THRESH,
                                              BEM_SELF_TERM, dtype=np.float64),
                                  device=DEV)
    ref64s = csr_of(S64, f64)
    cases = (
        ("B1 f32->f64 BEM", lambda: S32 @ x64,
         lambda: plain_buckets_sym(S32, x64, dtype=f64), S32, f64,
         {"B1": 2, "B1 sym": 1}, fma_entry("B1", f32, f64),
         ref64, x64, (("float64 CSR", ref64, x64),)),
        ("B9 element f32 BEM", lambda: bucket_route_sym(Ss, xs),
         lambda: plain_buckets_sym(Ss, xs, dtype=f32), Ss, f32,
         {"B9 element": 2, "B9 element sym": 1}, fma_entry("B9", f32, f32),
         refs64, xs, (("float32 CSR", refs32, xs),
                      ("float64 CSR", refs64, xs64))),
        ("B9 element f32->f64 BEM", lambda: Ss @ xs64,
         lambda: plain_buckets_sym(Ss, xs64, dtype=f64), Ss, f64,
         {"B9 element": 2, "B9 element sym": 1}, fma_entry("B9", f32, f64),
         refs64, xs64, (("float64 CSR", refs64, xs64),)),
        ("B1 f64 BEM", lambda: S64 @ x64,
         lambda: plain_buckets_sym(S64, x64, dtype=f64), S64, f64,
         {"B1": 2, "B1 sym": 1}, fma_entry("B1", f64, f64), ref64s, x64,
         (("float64 CSR", ref64s, x64),)))
    for key, fn, plain, op, compute, want, entry, ref, v, libs in cases:
        reset_counts()
        y = fn()
        torch.cuda.synchronize()
        require(counts() == merged(want) and entry_counts() == {entry: 2},
                f"{key}: launches {counts()}, {entry_counts()}")
        out["launches"][key] = 2
        out["errs"][key] = rel_check(f"{key} (n={n}) vs its values in a "
                                     f"float64 CSR", y, ref @ v.double(),
                                     TOL[compute])
        out["times"][key] = timed(f"{key} (n={n}, r=1)", fn, plain,
                                  product_bound(op, 1, compute), card)
        out["lib"][key] = {label: library_ms(f"{key}: {label} (cuSPARSE)",
                                             lambda c=c, u=u: c @ u, y, card)
                           for label, c, u in libs}
    out["ops"] = {(f32, "B9"): Ss, (f64, "B1"): S64}  # for the rule scan
    del ref64, refs64, refs32, ref64s
    return out


# the BEM in each stored dtype: (numpy dtype of bem_system, torch dtype of
# the constructor, wavenumber)
R1_SCAN_STORED = {torch.float32: (np.float32, None, 0.0),
                  torch.float64: (np.float64, None, 0.0),
                  torch.complex64: (np.complex64, None, HELMHOLTZ_K),
                  torch.complex128: (np.complex128, None, HELMHOLTZ_K),
                  torch.bfloat16: (np.float32, torch.bfloat16, 0.0)}


def r1_rule_scan(ops: dict, perm, card) -> dict:
    """The measurement behind ``fused_spmm.R1_RULES``: for every stored /
    compute pair, both r = 1 bodies on the BEM at n = 8192 stored in that
    dtype, B1 on its contiguous operator's chunked tables and B9's element
    pass on its copy on scattered index lists (``perm``, schedule
    "serial"), with a random operand of the compute dtype.  ``ops``: the
    operators already built, by (stored dtype, "B1" or "B9"); the others
    are built here.  Per cell ``r1_compare``'s numbers; the faster body
    printed beside the rule's."""
    n = BEM_NPTS
    gen = torch.Generator().manual_seed(19)
    out = {}
    for stored, (np_dt, cast, k) in R1_SCAN_STORED.items():
        args = (n, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM, k, np_dt)
        built = {kind: ops.get((stored, kind)) or bt.SymmetricBlockMatrix(
                     *bem_system(*args, perm=perm if kind == "B9" else None),
                     dtype=cast, device=DEV,
                     **({"schedule": "serial"} if kind == "B9" else {}))
                 for kind in ("B1", "B9")}
        for compute in fused_spmm.COMPUTE_TYPES[stored]:
            v = torch.randn(n, generator=gen, dtype=compute).to(DEV)
            for kind, op in built.items():
                key = f"{kind} {pair_name(stored, compute)}"
                res = r1_compare(f"rule scan {key}", [
                    t_ for t_ in op_tables(op) if t_[2] == kind], v, card)
                res["rule"] = res["rule"][kind]
                res["faster"] = ("rows" if res["rows_graph_ms"] <
                                 res["tile_graph_ms"] else "tile")
                out[key] = res
        del built
    print(f"  r = 1 rule scan, the BEM n={n} (B1 contiguous, B9 scattered), "
          f"graph ms row-stream / tile core -> faster (rule): " + "; ".join(
              f"{key} {r_['rows_graph_ms']:.4f} / {r_['tile_graph_ms']:.4f} "
              f"-> {r_['faster']} ({r_['rule']})" for key, r_ in out.items())
          + f" [{card}]")
    return out


def pass_split(label, table, own, X, card) -> dict:
    """Graph ms of each of the owner mode's two launches alone, with the
    bound of each: the products pass's values, gathered x (each row once)
    and scratch written, 2 operations per multiply-add; the sum pass's
    scratch read and y read and written."""
    P = torch.empty((own.p_rows, X.shape[1]), dtype=X.dtype, device=DEV)
    products = (lambda: mask_select.owner_products(table, own, X, P, 0,
                                                   False))
    sums = (lambda: mask_select.owner_sum(own, P, torch.zeros_like(X)))
    products()
    p_ms, s_ms = graph_ms(products), graph_ms(sums)
    esz = X.element_size()
    vals = sum(v.numel() * v.element_size() for v in table.values)
    flops = 2.0 * sum(v.numel() for v in table.values) * X.shape[1]
    p_bnd = bound(vals + X.numel() * esz + own.p_rows * X.shape[1] * esz,
                  flops)
    s_bnd = bound((int(own.ptr[-1]) + 2 * own.n_rows) * X.shape[1] * esz, 0)
    print(f"  {label}: products pass alone {p_ms:.4f} ms graph (bound "
          f"{p_bnd[0]:.4g} ms, {p_bnd[1]}), sum pass alone {s_ms:.4f} ms "
          f"(bound {s_bnd[0]:.4g} ms, {s_bnd[1]}); scratch "
          f"{own.p_rows * X.shape[1] * esz / 1e6:.1f} MB [{card}]")
    return {"products_graph_ms": p_ms, "sum_graph_ms": s_ms,
            "products_bound_ms": p_bnd[0], "sum_bound_ms": s_bnd[0],
            "scratch_mb": own.p_rows * X.shape[1] * esz / 1e6}


def sorted_real_size(card, n=8192, nblocks=2000, bs=128, r_wide=128) -> dict:
    """Config 1 (phase 3's operand, n = 8192, 2000 x 128^2 f32) renumbered
    through a permutation with ``scatter="sorted"``: its bucket route
    driven explicitly at r = 1 and 128 in the owner mode (its own route
    printed beside), two products bit-equal, against the atomic element
    pass on the same buckets and a float64 CSR of the values, timed with
    the atomic pass, the f32 CSR call and the bound."""
    t = time.perf_counter()
    A, _ = contiguous_operator(n, nblocks, bs, seed=7, value_seed=7 + 7777,
                               device=DEV)
    perm = np.random.default_rng(17).permutation(n)
    O = scattered_copy(A, perm, scatter="sorted")
    del A
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    tabs = bucket_tables(O._buckets, O.layout)
    require(tabs["chunked"] is None, "the sorted config 1 must have element "
            "buckets only")
    table, n = tabs["element"], O.shape[0]
    own = mask_select.owner_table(table, False, n)
    nnz = int(own.ptr[-1])
    print(f"  sorted config 1 (n={n}, {nblocks} x {bs}x{bs} f32 on scattered "
          f"indices, {logical_nnz(O) * 4 / 1e6:.1f} MB of values): "
          f"{own.n_rows} owned rows, {nnz} contributions, at most "
          f"{int(own.lengths.max())} per row; construction {setup_s:.2f} s")
    gen = torch.Generator().manual_seed(17)
    sorted_ = (lambda v: apply_operand(O._buckets, O.layout, n, v,
                                       scatter="sorted"))
    atomic = (lambda v: apply_operand(O._buckets, O.layout, n, v))
    csr32, csr64 = csr_of(O, torch.float32), csr_of(O, torch.float64)
    out = {"times": {}, "lib": {}, "errs": {}, "owned_rows": own.n_rows,
           "contributions": nnz, "setup_s": setup_s}
    for r in (1, r_wide):
        v = torch.randn((n, r), generator=gen).to(DEV)
        v = v[:, 0].contiguous() if r == 1 else v
        reset_counts()
        y1, y2 = sorted_(v), sorted_(v)
        torch.cuda.synchronize()
        k = 2  # the two passes
        require(counts() == merged({"B9 owner": 2 * k}),
                f"sorted config 1 r={r}: launches {counts()}")
        require(torch.equal(y1, y2), f"sorted config 1 r={r}: two products "
                f"are not bit-identical")
        reset_counts()
        O @ v
        torch.cuda.synchronize()
        print(f"  sorted config 1 r={r}: the bucket route driven in the "
              f"owner mode ({k} launches, two products bit-identical); "
              f"the operator's own route launches "
              f"{ {k_: c for k_, c in counts().items() if c} }")
        key = "r=1" if r == 1 else "r=128"
        out["errs"][key] = max(
            rel_check(f"sorted config 1 r={r} vs atomic", y1, atomic(v),
                      TOL32),
            rel_check(f"sorted config 1 r={r} vs float64 CSR", y1,
                      csr64 @ v.double(), TOL32))
        out["times"][key] = timed(
            f"sorted config 1 r={r} (B9 owner mode)", lambda v=v: sorted_(v),
            lambda v=v: mask_select.owner_apply_plain(
                table, v, out=torch.zeros_like(v)),
            product_bound(O, r), card, plain_graph=False)
        a_ms, a_gms = median_ms(lambda v=v: atomic(v)), graph_ms(
            lambda v=v: atomic(v))
        out["times"][f"atomic {key}"] = {"ms": a_ms, "graph_ms": a_gms}
        print(f"  atomic config 1 r={r} (B9 element pass) beside it: eager "
              f"{a_ms:.4f} ms, graph {a_gms:.4f} ms [{card}]")
        out["lib"][key] = library_ms(
            f"sorted config 1 r={r}: float32 CSR (cuSPARSE)",
            lambda v=v: csr32 @ v, y1, card)
        if r > 1:
            out["times"]["passes r=128"] = pass_split(
                f"sorted config 1 r={r}", table, own, v, card)
    del O, csr32, csr64
    return out


def config1_f64(card) -> dict:
    """Config 1 (phase 3's operand: n = 8192, 2000 x 128^2) stored float64:
    ``A @ X`` and ``A.T @ X`` at r = 128 (B1's float64 tensor-core
    instance where the rule says) against float64 scipy, exact launches by
    entry point, timed eager and from a CUDA graph beside the FMA instance
    on the same table, a float64 CSR @ X call and the bound; both
    instances scanned over r."""
    f64 = torch.float64
    t = time.perf_counter()
    A32, _ = contiguous_operator(8192, 2000, 128, seed=7, value_seed=7 + 7777,
                                 device="cpu")
    nb = A32.nblocks
    A = bt.BlockSparseMatrix(
        [A32.block(i).astype(np.float64) for i in range(nb)],
        [A32.blockrowindices(i) for i in range(nb)],
        [A32.blockcolindices(i) for i in range(nb)], A32.shape, device=DEV)
    del A32
    torch.cuda.synchronize()
    res = {"errs": {}, "times": {}, "launches": 0,
           "setup_s": time.perf_counter() - t}
    n = A.shape[0]
    table = bucket_tables(A._buckets, A._layout)["chunked"]
    require(bucket_tables(A._buckets, A._layout)["element"] is None,
            "config 1 must have chunked buckets only")
    sref = bt.to_scipy(A).tocsr()
    X = torch.randn((n, 128), generator=torch.Generator().manual_seed(19),
                    dtype=f64).to(DEV)
    Xn = X.cpu().numpy()
    mma = fused_spmm.b1_instance(f64, f64, 128, table.depth) == "mma"
    entry = fused_spmm.MMA_RULES[(f64, f64)].entry if mma else \
        "bst_fused_spmm_multi_f64"
    r_, c_, v_ = bt.rowcolvals(A)
    ij = torch.from_numpy(np.stack([r_, c_])).to(DEV)
    vals = torch.from_numpy(np.asarray(v_, np.float64)).to(DEV)
    csrs = {mode: torch.sparse_coo_tensor(ij.flip(0) if mode else ij, vals,
                                          (n, n)).coalesce().to_sparse_csr()
            for mode in (0, 1)}
    del ij, vals
    for label, fn, ref, mode in (
            ("A @ X", lambda: A @ X, lambda: sref @ Xn, 0),
            ("A.T @ X", lambda: A.T @ X, lambda: sref.T @ Xn, 1)):
        reset_counts()
        Y = fn()
        torch.cuda.synchronize()
        require(counts() == merged({"B1": 1, "B1 mma": int(mma)}) and
                entry_counts() == {entry: 1},
                f"config 1 f64 {label}: launches {counts()}, "
                f"{entry_counts()}")
        res["launches"] += counts()["B1 mma"]
        res["errs"][label] = rel_check(
            f"config 1 stored f64 {label} r=128 vs float64 scipy", Y, ref(),
            TOL[f64])
        fma = (lambda mode=mode: tables_product([(table, mode)], X, "fma"))
        rel_check(f"config 1 f64 {label}: the FMA instance vs the product",
                  fma(), Y, TOL[f64])
        plain = fused_spmm.mma_apply_plain if mma else \
            fused_spmm.multi_block_apply_plain
        tm = timed(f"config 1 stored f64 {label} r=128 (1 B1"
                   f"{' on the tensor cores' if mma else ''})", fn,
                   lambda mode=mode: plain(table, X, out=torch.zeros_like(X),
                                           transpose=bool(mode)),
                   product_bound(A, 128, f64), card)
        tm["fma_ms"], tm["fma_graph_ms"] = median_ms(fma), graph_ms(fma)
        lib = library_ms(f"config 1 f64 {label}: float64 CSR @ X "
                         f"(torch.sparse)", lambda c=csrs[mode]: c @ X, Y,
                         card)
        tm["library_ms"], tm["library_graph_ms"] = lib, lib.graph
        print(f"  config 1 f64 {label}: the FMA instance on the same table "
              f"eager {tm['fma_ms']:.4f}, graph {tm['fma_graph_ms']:.4f} ms "
              f"[{card}]")
        res["times"][label] = tm
    del csrs, sref
    res["scan"] = instance_scan("float64", [(table, 0)], f64, n, card,
                                MMA_SCAN_R + (128,))
    return res


def phase14(card: str) -> dict:
    n, ncl, thresh, st = BEM_NPTS, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM
    print(f"phase 14: options, dtype rules and interop: bf16 storage and "
          f"mixed operands on the BEM operator (n={n}) and the flagship "
          f"(4096^2, 200 x 64x64), scatter='sorted', save / load, to_bcoo, "
          f"schedule='auto' [{card}]")
    t_phase = time.perf_counter()
    out = {"errs": {}, "times": {}, "launches": {}, "setup": {}}
    times, errs, launches = out["times"], out["errs"], out["launches"]
    f32, f64, c64, c128 = (torch.float32, torch.float64, torch.complex64,
                           torch.complex128)
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(n, generator=gen).to(DEV)
    X = torch.randn((n, 64), generator=gen).to(DEV)
    x64 = x.double()
    perm = np.random.default_rng(14).permutation(n)
    ip = torch.from_numpy(perm).to(DEV)

    def renumbered(v):
        w = torch.empty_like(v)
        w[ip] = v
        return w

    # 1. bf16 storage: phase 12's BEM operator, contiguous (B1) and
    # scattered (B9's element pass)
    t = time.perf_counter()
    args = bem_system(n, ncl, thresh, st)
    S32 = bt.SymmetricBlockMatrix(*args, device=DEV)
    S16 = bt.SymmetricBlockMatrix(*args, dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    out["setup"]["bf16 and f32 BEM operators"] = time.perf_counter() - t
    require(S16.dtype == torch.bfloat16 and all(
        b[0].dtype == torch.bfloat16 for b in S16._dbuckets + S16._obuckets),
        "the bf16 operator must stage bf16 values")
    mb16, mb32 = logical_nnz(S16) * 2 / 1e6, logical_nnz(S32) * 4 / 1e6
    print(f"  {S16}: {mb16:.1f} MB of stored bf16 values ({mb32:.1f} MB as "
          f"f32)")
    out["stored_mb"] = {"bf16": mb16, "f32": mb32}
    ref16 = csr_of(S16, f64)  # its bf16 values, exactly, in float64
    errs.update({f"bf16 {k}": v for k, v in bucket_launch_check(
        "bf16 BEM", S16, (x, X, x64), TOL32).items()})
    # S16 @ X (r = 64) on B1's bf16 -> f32 tensor-core instance where the
    # rule says, the r = 1 products on the FMA instances
    k16 = mma_tables(S16, f32, 64)
    mma16 = k16 == 2
    mma16_entry = fused_spmm.MMA_RULES[(torch.bfloat16, f32)].entry
    reset_counts()
    y1, Y, y64 = S16 @ x, S16 @ X, S16 @ x64
    torch.cuda.synchronize()
    want = merged({"B1": 6, "B1 sym": 3, "B1 mma": k16})
    require(counts() == want, f"bf16 BEM products: launches {counts()}")
    ent = entry_counts()
    bf16 = torch.bfloat16
    want_ent = entries((fma_entry("B1", bf16, f32), 2),
                       (fma_entry("B1", bf16, f32, 64), 2 - k16),
                       (fma_entry("B1", bf16, f64), 2), (mma16_entry, k16))
    require(ent == want_ent, f"bf16 BEM products: entry points {ent}, want "
            f"{want_ent}")
    launches["B1 bf16->f32"] = ent[fma_entry("B1", bf16, f32)]
    launches["B1 bf16->f64"] = ent[fma_entry("B1", bf16, f64)]
    launches["B1 mma bf16->f32"] = ent.get(mma16_entry, 0)
    print(f"  S16 @ x, S16 @ X, S16 @ x64: launches {ent} (2 B1 per product, "
          f"one symmetric; S16 @ X on the tensor cores: {mma16}; no B3, B5 "
          f"or B9)")
    require((y1.dtype, Y.dtype, y64.dtype) == (f32, f32, f64),
            f"bf16 products' dtypes {y1.dtype}, {Y.dtype}, {y64.dtype}")
    errs["bf16 S @ x vs f32"] = rel_check("S16 @ x vs S32 @ x (bf16 storage)",
                                          y1, S32 @ x, 2e-2)
    errs["bf16 S @ X vs f32"] = rel_check("S16 @ X vs S32 @ X (bf16 storage)",
                                          Y, S32 @ X, 2e-2)
    errs["B1 bf16->f32"] = max(
        rel_check("S16 @ x vs its bf16 values in float64", y1, ref16 @ x64,
                  TOL32),
        rel_check("S16 @ X vs its bf16 values in float64", Y,
                  ref16 @ X.double(), TOL32))
    errs["B1 bf16->f64"] = rel_check("S16 @ x64 vs its bf16 values in "
                                     "float64", y64, ref16 @ x64, TOL[f64])
    b16 = {r: product_bound(S16, r, f32) for r in (1, 64)}
    times["B1 bf16->f32"] = timed(
        "S16 @ x (bf16 -> f32, B1)", lambda: S16 @ x,
        lambda: plain_buckets_sym(S16, x, dtype=f32), b16[1], card)
    times["B1 bf16->f32 r=64"] = timed(
        f"S16 @ X r=64 (bf16 -> f32, B1{' tensor cores' if mma16 else ''})",
        lambda: S16 @ X,
        (lambda: mma_plain_sym(S16, X)) if mma16
        else (lambda: plain_buckets_sym(S16, X, dtype=f32)), b16[64], card)
    fma16 = (lambda: b1_instance_product(S16, X, "fma"))
    rel_check("S16 @ X: the FMA instance vs the product", fma16(), Y, TOL32)
    times["B1 bf16->f32 r=64"].update(fma_ms=median_ms(fma16),
                                      fma_graph_ms=graph_ms(fma16))
    print(f"  S16 @ X r=64: the FMA instance on the same tables eager "
          f"{times['B1 bf16->f32 r=64']['fma_ms']:.4f}, graph "
          f"{times['B1 bf16->f32 r=64']['fma_graph_ms']:.4f} ms [{card}]")
    out["bf16 scan"] = instance_scan("bf16 -> f32",
                                     zip(sym_b1_tables(S16), (0, 2)), f32, n,
                                     card)
    times["B1 bf16->f64"] = timed(
        "S16 @ x64 (bf16 -> f64, B1)", lambda: S16 @ x64,
        lambda: plain_buckets_sym(S16, x64, dtype=f64),
        product_bound(S16, 1, f64), card)
    ref16_32 = csr_of(S16, f32)  # the same values, exactly, in float32
    lib = {"B1 bf16->f32": library_ms(
               "S16 @ x: its bf16 values in a float32 CSR (cuSPARSE)",
               lambda: ref16_32 @ x, y1, card),
           "B1 bf16->f64": library_ms(
               "S16 @ x64: its bf16 values in a float64 CSR (cuSPARSE)",
               lambda: ref16 @ x64, y64, card)}
    lib["B1 bf16->f32 r=64"] = library_ms(
        "S16 @ X r=64: its bf16 values in a float32 CSR @ X (cuSPARSE)",
        lambda: ref16_32 @ X, Y, card)
    del ref16_32
    for label, fn, r in (("S32 @ x (the f32 route: B5)", lambda: S32 @ x, 1),
                         ("S32 @ X r=64 (the f32 route: B3)",
                          lambda: S32 @ X, 64)):
        ms, gms = median_ms(fn), graph_ms(fn)
        bnd = product_bound(S32, r)
        times[f"f32 route r={r}"] = {"ms": ms, "graph_ms": gms, "bound": bnd}
        print(f"  {label}: eager {ms:.4f} ms, graph {gms:.4f} ms, bound "
              f"{bnd[0]:.4g} ms ({bnd[1]}) [{card}]")

    # the BEM operator with an f64 operand (B1 f32 -> f64), and its
    # scattered copy's element pass in f32 and f32 -> f64, each beside the
    # CSR call of its compute type: the real-size rows of the comparisons
    # that sit at the replay floor on the flagship
    rule2 = real_size_rule2(S32, args, perm, x, x64, renumbered, card)
    times.update(rule2["times"])
    lib.update(rule2["lib"])
    errs.update(rule2["errs"])
    launches.update(rule2["launches"])

    t = time.perf_counter()
    Ss16 = bt.SymmetricBlockMatrix(*bem_system(n, ncl, thresh, st, perm=perm),
                                   dtype=torch.bfloat16, device=DEV,
                                   schedule="serial")
    torch.cuda.synchronize()
    out["setup"]["scattered bf16 BEM operator"] = time.perf_counter() - t
    require(all(b.chunk == 1 for lay in (Ss16._dlayout, Ss16._olayout)
                for b in lay.buckets), "the scattered variant must have "
            "element buckets only")
    xs, Xs, xs64 = renumbered(x), renumbered(X), renumbered(x64)
    errs.update({f"bf16 scattered {k}": v for k, v in bucket_launch_check(
        "scattered bf16 BEM", Ss16, (xs, Xs, xs64), TOL32).items()})
    reset_counts()
    ys, Ys, ys64 = Ss16 @ xs, Ss16 @ Xs, Ss16 @ xs64
    torch.cuda.synchronize()
    require(counts() == merged({"B9 element": 6, "B9 element sym": 3}),
            f"scattered bf16 BEM products: launches {counts()}")
    ent = entry_counts()
    require(ent == entries((fma_entry("B9", bf16, f32), 2),
                           (fma_entry("B9", bf16, f32, 64), 2),
                           (fma_entry("B9", bf16, f64), 2)),
            f"scattered bf16 BEM products: entry points {ent}")
    launches["B9 element bf16->f32"] = ent[fma_entry("B9", bf16, f32)]
    launches["B9 element bf16->f64"] = ent[fma_entry("B9", bf16, f64)]
    print(f"  scattered S16 @ x, @ X, @ x64 (serial): launches {ent}")
    errs["B9 element bf16->f32"] = max(
        rel_check("scattered S16 @ x vs its bf16 values in float64", ys[ip],
                  ref16 @ x64, TOL32),
        rel_check("scattered S16 @ X vs its bf16 values in float64", Ys[ip],
                  ref16 @ X.double(), TOL32))
    errs["B9 element bf16->f64"] = rel_check(
        "scattered S16 @ x64 vs its bf16 values in float64", ys64[ip],
        ref16 @ x64, TOL[f64])
    times["B9 element bf16->f32"] = timed(
        "scattered S16 @ x (bf16 -> f32, B9 element pass)", lambda: Ss16 @ xs,
        lambda: plain_buckets_sym(Ss16, xs, dtype=f32),
        product_bound(Ss16, 1, f32), card)
    times["B9 element bf16->f64"] = timed(
        "scattered S16 @ x64 (bf16 -> f64, B9 element pass)",
        lambda: Ss16 @ xs64, lambda: plain_buckets_sym(Ss16, xs64, dtype=f64),
        product_bound(Ss16, 1, f64), card)
    refs16, refs16_32 = csr_of(Ss16, f64), csr_of(Ss16, f32)
    lib["B9 element bf16->f32"] = library_ms(
        "scattered S16 @ x: its bf16 values in a float32 CSR (cuSPARSE)",
        lambda: refs16_32 @ xs, ys, card)
    lib["B9 element bf16->f64"] = library_ms(
        "scattered S16 @ x64: its bf16 values in a float64 CSR (cuSPARSE)",
        lambda: refs16 @ xs64, ys64, card)
    del ref16, refs16, refs16_32

    # 2. mixed operands: an f64 operand on the f32 flagship (B1) and on its
    # scattered copy (B9's element pass), a complex128 operand on the
    # complex64 Helmholtz BEM (phase 13's recipe, both numberings)
    A, rng = contiguous_operator(4096, 200, 64, seed=7, value_seed=None,
                                 device=DEV)
    fperm = np.random.default_rng(15).permutation(4096)
    fip = torch.from_numpy(fperm).to(DEV)
    As = scattered_copy(A, fperm)
    require(all(b.chunk == 1 for b in As.layout.buckets),
            "the scattered flagship must have element buckets only")
    xn = rng.standard_normal(4096)
    Xn = rng.standard_normal((4096, 64))
    fx, fX = torch.from_numpy(xn).to(DEV), torch.from_numpy(Xn).to(DEV)
    fxs, fXs = torch.empty_like(fx), torch.empty_like(fX)
    fxs[fip], fXs[fip] = fx, fX
    Sref = bt.to_scipy(A).astype(np.float64)
    errs.update({f"f32->f64 {k}": v for k, v in bucket_launch_check(
        "flagship f64 operand", A, (fx, fX), TOL[f64]).items()})
    errs.update({f"f32->f64 scattered {k}": v for k, v in bucket_launch_check(
        "scattered flagship f64 operand", As, (fxs, fXs), TOL[f64]).items()})
    reset_counts()
    y, yt, Yf = A @ fx, A.T @ fx, A @ fX
    torch.cuda.synchronize()
    require(counts() == merged({"B1": 3}) and entry_counts() == entries(
        (fma_entry("B1", f32, f64), 2), (fma_entry("B1", f32, f64, 64), 1)),
        f"flagship f64 products: launches {counts()}, {entry_counts()} "
        f"(the f32 -> f64 instance of B1, no B2 or B5)")
    launches["B1 f32->f64"] = 3
    reset_counts()
    ys, Ys = As @ fxs, As @ fXs
    torch.cuda.synchronize()
    require(counts() == merged({"B9 element": 2}) and entry_counts() ==
            entries((fma_entry("B9", f32, f64), 1),
                    (fma_entry("B9", f32, f64, 64), 1)),
        f"scattered flagship f64 products: launches {counts()}, "
        f"{entry_counts()}")
    launches["B9 element f32->f64"] = 2
    print(f"  flagship A @ x64, A.T @ x64, A @ X64: 3 launches of B1's f32 -> "
          f"f64 instances (r = 1: {fma_entry('B1', f32, f64)}), no B2 or B5; "
          f"scattered copy: 2 of B9's ({fma_entry('B9', f32, f64)} at r = 1)")
    require(all(v.dtype == f64 for v in (y, yt, Yf, ys, Ys)),
            "f32 operator x f64 operand must give f64")
    errs["B1 f32->f64"] = max(
        rel_check("A @ x64 vs float64 scipy", y, Sref @ xn, TOL[f64]),
        rel_check("A.T @ x64 vs float64 scipy", yt, Sref.T @ xn, TOL[f64]),
        rel_check("A @ X64 vs float64 scipy", Yf, Sref @ Xn, TOL[f64]))
    errs["B9 element f32->f64"] = max(
        rel_check("scattered A @ x64 vs float64 scipy", ys[fip], Sref @ xn,
                  TOL[f64]),
        rel_check("scattered A @ X64 vs float64 scipy", Ys[fip], Sref @ Xn,
                  TOL[f64]))
    flag64 = csr_of(A, f64)
    flag64s = csr_of(As, f64)
    times["B1 f32->f64"] = timed(
        "A @ x64 (f32 -> f64, B1)", lambda: A @ fx,
        lambda: plain_buckets(A.layout, A._buckets, fx, 4096, f64),
        product_bound(A, 1, f64), card)
    times["B1 f32->f64"]["r1"] = r1_compare("flagship A @ x64", op_tables(A),
                                            fx, card)
    times["B1 f32->f64 r=64"] = timed(
        "A @ X64 r=64 (f32 -> f64, B1)", lambda: A @ fX,
        lambda: plain_buckets(A.layout, A._buckets, fX, 4096, f64),
        product_bound(A, 64, f64), card)
    x32 = fx.float()
    ms, gms = median_ms(lambda: A @ x32), graph_ms(lambda: A @ x32)
    times["flagship f32 route r=1"] = {"ms": ms, "graph_ms": gms}
    print(f"  A @ x (f32, the f32 instance of B1): eager {ms:.4f} ms, graph "
          f"{gms:.4f} ms [{card}]")
    times["B9 element f32->f64"] = timed(
        "scattered A @ x64 (f32 -> f64, B9 element pass)", lambda: As @ fxs,
        lambda: plain_buckets(As.layout, As._buckets, fxs, 4096, f64),
        product_bound(As, 1, f64), card)
    times["B9 element f32->f64"]["r1"] = r1_compare(
        "scattered flagship A @ x64", op_tables(As), fxs, card)
    lib["B1 f32->f64"] = library_ms("A @ x64: float64 CSR (cuSPARSE)",
                                    lambda: flag64 @ fx, y, card)
    lib["B9 element f32->f64"] = library_ms(
        "scattered A @ x64: float64 CSR (cuSPARSE)", lambda: flag64s @ fxs,
        ys, card)

    t = time.perf_counter()
    argsc = bem_system(n, ncl, thresh, st, HELMHOLTZ_K, np.complex64)
    Sc = bt.SymmetricBlockMatrix(*argsc, device=DEV)
    Scs = bt.SymmetricBlockMatrix(
        *bem_system(n, ncl, thresh, st, HELMHOLTZ_K, np.complex64,
                    perm=perm), device=DEV, schedule="serial")
    torch.cuda.synchronize()
    out["setup"]["complex64 BEM operators"] = time.perf_counter() - t
    refc = csr_of(Sc, c128)
    xc = torch.randn(n, generator=gen, dtype=c128).to(DEV)
    Xc = torch.randn((n, 64), generator=gen, dtype=c128).to(DEV)
    xcs, Xcs = renumbered(xc), renumbered(Xc)
    errs.update({f"c64->c128 {k}": v for k, v in bucket_launch_check(
        "complex BEM c128 operand", Sc, (xc, Xc), TOL[c128]).items()})
    errs.update({f"c64->c128 scattered {k}": v for k, v in
                 bucket_launch_check("scattered complex BEM c128 operand",
                                     Scs, (xcs, Xcs), TOL[c128]).items()})
    reset_counts()
    yc, Yc, yh = Sc @ xc, Sc @ Xc, Sc.H @ xc
    torch.cuda.synchronize()
    require(counts() == merged({"B1": 6, "B1 sym": 3}) and entry_counts() ==
            entries((fma_entry("B1", c64, c128), 4),
                    (fma_entry("B1", c64, c128, 64), 2)),
            f"complex BEM c128 products: launches {counts()}, "
            f"{entry_counts()}")
    launches["B1 c64->c128"] = 6
    reset_counts()
    ycs, Ycs = Scs @ xcs, Scs @ Xcs
    torch.cuda.synchronize()
    require(counts() == merged({"B9 element": 4, "B9 element sym": 2}) and
            entry_counts() == entries((fma_entry("B9", c64, c128), 2),
                                      (fma_entry("B9", c64, c128, 64), 2)),
            f"scattered complex BEM c128 products: launches {counts()}, "
            f"{entry_counts()}")
    launches["B9 element c64->c128"] = 4
    print(f"  complex64 BEM @ complex128: 6 launches of B1's c64 -> c128 "
          f"instances (S @ x, S @ X, S.H @ x; r = 1: "
          f"{fma_entry('B1', c64, c128)}); scattered: 4 of B9's "
          f"({fma_entry('B9', c64, c128)} at r = 1)")
    require(all(v.dtype == c128 for v in (yc, Yc, yh, ycs, Ycs)),
            "complex64 operator x complex128 operand must give complex128")
    errs["B1 c64->c128"] = max(
        rel_check("Sc @ xc128 vs its values in complex128", yc, refc @ xc,
                  TOL[c128]),
        rel_check("Sc @ Xc128 vs its values in complex128", Yc, refc @ Xc,
                  TOL[c128]),
        rel_check("Sc.H @ xc128 vs its values in complex128", yh,
                  (refc @ xc.conj()).conj(), TOL[c128]))
    errs["B9 element c64->c128"] = max(
        rel_check("scattered Sc @ xc128 vs its values in complex128",
                  ycs[ip], refc @ xc, TOL[c128]),
        rel_check("scattered Sc @ Xc128 vs its values in complex128",
                  Ycs[ip], refc @ Xc, TOL[c128]))
    times["B1 c64->c128"] = timed(
        "Sc @ xc128 (c64 -> c128, B1)", lambda: Sc @ xc,
        lambda: plain_buckets_sym(Sc, xc, dtype=c128),
        product_bound(Sc, 1, c128), card)
    times["B9 element c64->c128"] = timed(
        "scattered Sc @ xc128 (c64 -> c128, B9 element pass)",
        lambda: Scs @ xcs, lambda: plain_buckets_sym(Scs, xcs, dtype=c128),
        product_bound(Scs, 1, c128), card)
    lib["B1 c64->c128"] = library_ms("Sc @ xc128: complex128 CSR (cuSPARSE)",
                                     lambda: refc @ xc, yc, card)
    refcs = csr_of(Scs, c128)
    lib["B9 element c64->c128"] = library_ms(
        "scattered Sc @ xc128: complex128 CSR (cuSPARSE)",
        lambda: refcs @ xcs, ycs, card)
    del refc, refcs
    # both r = 1 bodies on the BEM in every stored dtype, on the operators
    # built above where they exist
    out["r1 scan"] = r1_rule_scan(
        {**rule2["ops"], (f32, "B1"): S32, (torch.bfloat16, "B1"): S16,
         (torch.bfloat16, "B9"): Ss16, (c64, "B1"): Sc, (c64, "B9"): Scs},
        perm, card)
    del Sc, Scs, Ss16, rule2["ops"]

    # 3. scatter="sorted" on the scattered flagship: B9's owner mode
    Ao = scattered_copy(A, fperm, scatter="sorted")
    Aa = scattered_copy(A, fperm)
    table = bucket_tables(Ao._buckets, Ao.layout)["element"]
    require(bucket_tables(Ao._buckets, Ao.layout)["chunked"] is None,
            "the sorted flagship must have element buckets only")
    ox, oX = fxs.float(), fXs.float()
    errs["B9 owner kernel"] = launch_vs_plain(
        "B9 owner mode", table, mask_select.owner_apply,
        mask_select.owner_apply_plain, (ox, oX), ("forward", "transpose"),
        TOL32)
    own = mask_select.owner_table(table, False, 4096)
    print(f"  owner table: {own.n_rows} owned rows, {int(own.ptr[-1])} "
          f"contributions, at most {int(own.lengths.max())} per row")
    oX128 = torch.randn((4096, 128), generator=gen).to(DEV)
    reset_counts()
    runs = {label: [fn() for _ in range(3)]
            for label, fn in (("A @ x", lambda: Ao @ ox),
                              ("A @ X", lambda: Ao @ oX),
                              ("A.T @ x", lambda: Ao.T @ ox),
                              ("A @ X r=128", lambda: Ao @ oX128))}
    torch.cuda.synchronize()
    # each product the two passes
    want_entries = {"bst_element_owner_products_f32": 12,
                    "bst_element_owner_sum_f32": 12}
    require(counts() == merged({"B9 owner": 24}) and
            entry_counts() == want_entries, f"sorted products: launches "
            f"{counts()}, {entry_counts()} (the owner mode only: "
            f"{want_entries})")
    launches["B9 owner"] = 24
    for label, (p1, p2, p3) in runs.items():
        require(torch.equal(p1, p2) and torch.equal(p1, p3),
                f"sorted {label}: three products are not bit-identical")
    print(f"  sorted A @ x, A @ X (r = 64), A.T @ x, A @ X (r = 128): each "
          f"three times bit-identical (torch.equal); launches "
          f"{want_entries}, no element pass")
    Sref64 = torch.from_numpy(Sref.toarray()).to(DEV)
    errs["B9 owner"] = max(
        rel_check("sorted A @ x vs atomic", runs["A @ x"][0], Aa @ ox, TOL32),
        rel_check("sorted A.T @ x vs atomic", runs["A.T @ x"][0], Aa.T @ ox,
                  TOL32),
        rel_check("sorted A @ x vs float64 scipy", runs["A @ x"][0][fip],
                  Sref @ xn, TOL32),
        rel_check("sorted A @ X vs atomic", runs["A @ X"][0], Aa @ oX, TOL32),
        rel_check("sorted A @ X r=128 vs atomic", runs["A @ X r=128"][0],
                  Aa @ oX128, TOL32),
        rel_check("sorted A @ X vs float64 scipy", runs["A @ X"][0][fip],
                  Sref64 @ oX[fip].double(), TOL32),
        rel_check("sorted A @ X r=128 vs float64 scipy",
                  runs["A @ X r=128"][0][fip],
                  Sref64 @ oX128[fip].double(), TOL32))
    del Sref64
    plain_own = (lambda v: mask_select.owner_apply_plain(
        table, v, out=torch.zeros_like(v)))
    for r, v in ((1, ox), (64, oX)):
        times[f"B9 owner r={r}"] = timed(
            f"sorted A @ x r={r} (B9 owner mode)", lambda v=v: Ao @ v,
            lambda v=v: plain_own(v), product_bound(Ao, r), card,
            plain_graph=False)
        ms, gms = median_ms(lambda v=v: Aa @ v), graph_ms(lambda v=v: Aa @ v)
        times[f"B9 atomic r={r}"] = {"ms": ms, "graph_ms": gms}
        print(f"  atomic A @ x r={r} (B9 element pass) beside it: eager "
              f"{ms:.4f} ms, graph {gms:.4f} ms [{card}]")
    flag32s = csr_of(As, f32)
    lib["B9 owner"] = library_ms("sorted A @ x: float32 CSR (cuSPARSE)",
                                 lambda: flag32s @ ox, runs["A @ x"][0], card)
    lib["B9 owner r=64"] = library_ms(
        "sorted A @ X r=64: float32 CSR @ X (cuSPARSE)",
        lambda: flag32s @ oX, runs["A @ X"][0], card)
    times["B9 owner passes r=64"] = pass_split(
        "sorted A @ X r=64", table, own, oX, card)
    del runs, Ao, Aa, flag32s
    out["sorted config 1"] = sorted_real_size(card)

    owner_keys = owner_instances(A, fperm, fxs, fXs, out, lib, card)
    del As
    out["config 1 f64"] = config1_f64(card)

    # 4. save / load of the BEM operator, and interop
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bem.npz")
        t = time.perf_counter()
        bt.save(path, S32)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        L = bt.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        mb = os.path.getsize(path) / 1e6
        p16 = os.path.join(tmp, "bem16.npz")
        bt.save(p16, S16)
        L16 = bt.load(p16)
    require(L.device == S32.device and L.dtype == f32, f"loaded {L}")
    for a, b in zip(S32._dbuckets + S32._obuckets,
                    L._dbuckets + L._obuckets):
        require(all((u is None and v is None) or torch.equal(u, v)
                    for u, v in zip(a, b)), "loaded staged tensors differ")
    for a, b in zip(S16._dbuckets + S16._obuckets,
                    L16._dbuckets + L16._obuckets):
        require(b[0].dtype == torch.bfloat16 and torch.equal(
            a[0].view(torch.int16), b[0].view(torch.int16)),
            "loaded bf16 values differ")
    errs["load"] = max(rel_check("loaded S @ x vs the original", L @ x,
                                 S32 @ x, TOL32),
                       rel_check("loaded S @ X vs the original", L @ X,
                                 S32 @ X, TOL32))
    out["setup"].update({"save_s": save_s, "load_s": load_s, "file_mb": mb})
    print(f"  save {save_s:.2f} s, load onto the card {load_s:.2f} s "
          f"({mb:.1f} MB .npz); staged values and tables torch.equal; the "
          f"bf16 operator's values bit-equal after a round trip [{card}]")
    del L, L16

    M = bt.to_bcoo(S32)
    require(M.device == S32.device and M.is_coalesced(),
            "to_bcoo must give a coalesced tensor on the operator's card")
    csr = bt.to_scipy(S32).tocsr()
    csr.sum_duplicates()
    csr.sort_indices()
    rows = np.repeat(np.arange(n), np.diff(csr.indptr))
    idx = M.indices().cpu().numpy()
    require(np.array_equal(idx[0], rows) and np.array_equal(idx[1],
                                                            csr.indices),
            "to_bcoo's indices differ from to_scipy's")
    errs["to_bcoo"] = rel_check("to_bcoo values vs to_scipy", M.values(),
                                csr.data, TOL32)
    Sa = bt.SymmetricBlockMatrix(*args, schedule="auto", device=DEV)
    reset_counts()
    ya, Ya = Sa @ x, Sa @ X
    torch.cuda.synchronize()
    got_a = counts()
    reset_counts()
    S32 @ x, S32 @ X
    torch.cuda.synchronize()
    require(got_a == counts(), f"schedule='auto' launches {got_a}, the "
            f"colored operator's {counts()}")
    errs["auto"] = max(rel_check("schedule='auto' S @ x vs colored", ya,
                                 S32 @ x, TOL32),
                       rel_check("schedule='auto' S @ X vs colored", Ya,
                                 S32 @ X, TOL32))
    print(f"  to_bcoo on the card equal to to_scipy; schedule='auto' builds "
          f"and applies with the colored operator's launches "
          f"{ {k: v for k, v in got_a.items() if v} }")
    out["wall_s"] = time.perf_counter() - t_phase

    kernels = []
    specs = [
        ("fused_spmm bf16->f32 (B1)", "B1 bf16->f32", B1_SRC, B1_REPLACES,
         lib["B1 bf16->f32"], "S @ x, phase 12's BEM operator n=8192 stored bf16 (4251 "
         "blocks of 64x64), f32 operand"),
        ("fused_spmm bf16->f64 (B1)", "B1 bf16->f64", B1_SRC, B1_REPLACES,
         lib["B1 bf16->f64"], "S @ x64, the bf16 BEM operator, f64 operand"),
        ("fused_spmm f32->f64 (B1)", "B1 f32->f64", B1_SRC, B1_REPLACES,
         lib["B1 f32->f64"], "A @ x64, the flagship 4096^2 f32, f64 operand"),
        ("fused_spmm c64->c128 (B1)", "B1 c64->c128", B1_SRC, B1_REPLACES,
         lib["B1 c64->c128"], "S @ x128, phase 13's complex64 Helmholtz BEM "
         "n=8192, complex128 operand"),
        ("mask_select element pass bf16->f32 (B9)", "B9 element bf16->f32",
         B9_SRC, B9_SCATTER_REPLACES, lib["B9 element bf16->f32"], "S @ x, the bf16 BEM operator on "
         "scattered index lists (serial), f32 operand"),
        ("mask_select element pass bf16->f64 (B9)", "B9 element bf16->f64",
         B9_SRC, B9_SCATTER_REPLACES, lib["B9 element bf16->f64"], "S @ x64, the scattered bf16 BEM "
         "operator, f64 operand"),
        ("mask_select element pass f32->f64 (B9)", "B9 element f32->f64",
         B9_SRC, B9_SCATTER_REPLACES, lib["B9 element f32->f64"],
         "A @ x64, the flagship on scattered index lists, f64 operand"),
        ("mask_select element pass c64->c128 (B9)", "B9 element c64->c128",
         B9_SRC, B9_SCATTER_REPLACES, lib["B9 element c64->c128"],
         "S @ x128, the complex64 BEM on scattered index lists (serial)"),
        ("mask_select owner mode (B9, scatter='sorted')", "B9 owner",
         B9_OWNER_SRC, B9_SCATTER_REPLACES, lib["B9 owner"], "A @ x, the "
         "flagship on scattered index lists, scatter='sorted', f32, both "
         "launches (r64: A @ X); atomic_*: the element pass of the same "
         "operator with scatter='atomic'; cfg1_*: config 1 (n=8192, 2000 x "
         "128x128) renumbered, sorted, its bucket route at r = 128 (r1: "
         "r = 1)"),
    ]
    rule2_of = {"B1 f32->f64": "B1 f32->f64 BEM",
                "B9 element f32->f64": "B9 element f32->f64 BEM"}
    for name, key, src, rep, lib_ms, what in specs:
        t_ = times[key if key != "B9 owner" else "B9 owner r=1"]
        extra = {"max_abs_err_kernel": errs[KERNEL_ERR[key]]}
        if key == "B9 owner":
            cfg1 = out["sorted config 1"]
            extra.update({
                "replaces_also": SORTED_REPLACES,
                "entry_points": ["bst_element_owner_products_<pair>",
                                 "bst_element_owner_sum_<compute>"],
                "r64_ms": times["B9 owner r=64"]["ms"],
                "r64_graph_ms": times["B9 owner r=64"]["graph_ms"],
                "r64_library_ms": lib["B9 owner r=64"],
                "r64_library_graph_ms": lib["B9 owner r=64"].graph,
                "r64_bound_ms": times["B9 owner r=64"]["bound"][0],
                **{f"r64_{k}": v
                   for k, v in times["B9 owner passes r=64"].items()},
                "atomic_ms": times["B9 atomic r=1"]["ms"],
                "atomic_graph_ms": times["B9 atomic r=1"]["graph_ms"],
                "atomic_r64_ms": times["B9 atomic r=64"]["ms"],
                "atomic_r64_graph_ms": times["B9 atomic r=64"]["graph_ms"],
                "bit_identical_runs": 3,
                **{f"cfg1_{k}": cfg1["times"]["r=128"][k]
                   for k in ("ms", "graph_ms", "plain_ms")},
                "cfg1_bound_ms": cfg1["times"]["r=128"]["bound"][0],
                "cfg1_atomic_ms": cfg1["times"]["atomic r=128"]["ms"],
                "cfg1_atomic_graph_ms":
                    cfg1["times"]["atomic r=128"]["graph_ms"],
                "cfg1_library_ms": cfg1["lib"]["r=128"],
                "cfg1_library_graph_ms": cfg1["lib"]["r=128"].graph,
                "cfg1_max_abs_err": max(cfg1["errs"].values()),
                **{f"cfg1_{k}": v
                   for k, v in cfg1["times"]["passes r=128"].items()},
                "cfg1_r1_ms": cfg1["times"]["r=1"]["ms"],
                "cfg1_r1_graph_ms": cfg1["times"]["r=1"]["graph_ms"],
                "cfg1_r1_bound_ms": cfg1["times"]["r=1"]["bound"][0],
                "cfg1_r1_atomic_graph_ms":
                    cfg1["times"]["atomic r=1"]["graph_ms"],
                "cfg1_r1_library_graph_ms": cfg1["lib"]["r=1"].graph})
        if key == "B1 bf16->f32":
            extra.update({"f32_route_ms": times["f32 route r=1"]["ms"],
                          "f32_route_graph_ms":
                              times["f32 route r=1"]["graph_ms"],
                          "stored_mb": mb16, "stored_mb_f32": mb32})
        if key in rule2_of:  # its real-size row on the BEM operator
            t2 = times[rule2_of[key]]
            extra.update({"bem_ms": t2["ms"], "bem_graph_ms": t2["graph_ms"],
                          "bem_plain_ms": t2["plain_ms"],
                          "bem_bound_ms": t2["bound"][0],
                          "bem_max_abs_err": errs[rule2_of[key]],
                          **{f"bem_library_{lbl.split()[0]}_{k}": v
                             for lbl, lt in lib[rule2_of[key]].items()
                             for k, v in (("ms", float(lt)),
                                          ("graph_ms", lt.graph))},
                          "bem_timed": "phase 12's BEM operator n=8192 "
                                       "(scattered copy, serial, for B9)"})
        if key == "B1 f32->f64":
            extra.update({"r64_ms": times["B1 f32->f64 r=64"]["ms"],
                          "r64_graph_ms":
                              times["B1 f32->f64 r=64"]["graph_ms"],
                          "f32_ms": times["flagship f32 route r=1"]["ms"],
                          "f32_graph_ms":
                              times["flagship f32 route r=1"]["graph_ms"]})
        kernels.append(instance_entry(
            name, src, rep, launches[key], errs[key], t_, lib_ms, card, what,
            dtypes=([pair_name(s_, c_) for s_, c_ in VALUE_PAIRS]
                    if key == "B9 owner" else [key.split(" ")[-1]]),
            **extra))
    t16 = times["B1 bf16->f32 r=64"]
    kernels.append(instance_entry(
        "fused_spmm bf16->f32 tensor cores (B1)", B1_BF16_MMA_SRC,
        B1_REPLACES, launches["B1 mma bf16->f32"], errs["B1 bf16->f32"], t16,
        lib["B1 bf16->f32 r=64"], card, "S @ X r=64, phase 12's BEM operator "
        "n=8192 stored bf16, f32 operand, both launches; fma: the FMA "
        "instance on the same tables; f32_b3: the f32 operator's S @ X (B3); "
        "library: its bf16 values in an f32 CSR @ X", dtypes=["bf16->f32"],
        entry_points=[fused_spmm.MMA_RULES[(torch.bfloat16, f32)].entry],
        launches_by_path={"bf16 BEM S @ X r=64 (phase 14)":
                          launches["B1 mma bf16->f32"]},
        max_abs_err_vs_f32=errs["bf16 S @ X vs f32"],
        fma_ms=t16["fma_ms"], fma_graph_ms=t16["fma_graph_ms"],
        f32_b3_ms=times["f32 route r=64"]["ms"],
        f32_b3_graph_ms=times["f32 route r=64"]["graph_ms"],
        instance_scan_graph_ms=out["bf16 scan"]["scan"],
        scan_takes_from_r=out["bf16 scan"]["takes"],
        min_r=out["bf16 scan"]["min_r"],
        max_depth=fused_spmm.MMA_RULES[(torch.bfloat16, f32)].max_depth))
    c1 = out["config 1 f64"]
    kernels.append(instance_entry(
        "fused_spmm float64 tensor cores (B1)", B1_DMMA_SRC, B1_REPLACES,
        c1["launches"], max(c1["errs"].values()), c1["times"]["A @ X"],
        c1["times"]["A @ X"]["library_ms"], card, "A @ X r=128, config 1 "
        "(n=8192, 2000 x 128x128) stored f64; t_: A.T @ X; fma: the FMA "
        "instance on the same table; library: a float64 CSR @ X",
        dtypes=["float64"], entry_points=[fused_spmm.MMA_RULES[(f64, f64)]
                                          .entry],
        launches_by_path={"config 1 stored f64, A @ X and A.T @ X r=128 "
                          "(phase 14)": c1["launches"]},
        fma_ms=c1["times"]["A @ X"]["fma_ms"],
        fma_graph_ms=c1["times"]["A @ X"]["fma_graph_ms"],
        **{f"t_{k}": c1["times"]["A.T @ X"][k] for k in (
            "ms", "graph_ms", "plain_ms", "fma_ms", "fma_graph_ms")},
        t_library_ms=c1["times"]["A.T @ X"]["library_ms"],
        t_library_graph_ms=c1["times"]["A.T @ X"]["library_graph_ms"],
        instance_scan_graph_ms=c1["scan"]["scan"],
        scan_takes_from_r=c1["scan"]["takes"], min_r=c1["scan"]["min_r"],
        setup_s=c1["setup_s"]))
    t2 = times["B9 element f32 BEM"]
    rows = lib["B9 element f32 BEM"]
    kernels.append(instance_entry(
        "mask_select element pass f32 on the BEM (B9)", B9_SRC,
        B9_SCATTER_REPLACES, launches["B9 element f32 BEM"],
        errs["B9 element f32 BEM"], t2, rows["float32 CSR"], card,
        "S @ x, phase 12's BEM n=8192 on scattered index lists (serial), "
        "its bucket route driven explicitly, f32",
        library_f64_ms=float(rows["float64 CSR"]),
        library_f64_graph_ms=rows["float64 CSR"].graph))
    for key in owner_keys:
        pair = key.split(" ")[-1]
        kernels.append(instance_entry(
            f"mask_select owner mode {pair} (B9, scatter='sorted')", B9_SRC,
            B9_SCATTER_REPLACES, launches[key], errs[key], times[key],
            lib[key], card, f"A @ x, the flagship on scattered index lists, "
            f"scatter='sorted', stored {pair}", dtypes=[pair],
            max_abs_err_kernel=errs[f"{key} kernel"],
            replaces_also=SORTED_REPLACES))
    out["kernels"] = kernels
    out["rows library"] = lib["B9 element f32 BEM"]["float32 CSR"]
    print(f"  [phase 14 setup: "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["setup"].items()) + "]")
    return out


# -- phase 15: the distributed layer (--distributed) ---------------------------

DIST_SHARDS = {"bem": 4, "config 1": 4, "config 3": 8}
DIST_CONFIG1 = (8192, 2000, 128)  # n, blocks, block size: phase 3's operand
DIST_CONFIG3_N = 32768  # phase 7's operand


def dist_want(D, rings: int = 1) -> dict:
    """Exact launches of ``rings`` rings of ``D`` (a product, or one column
    group each): per shard one B1 launch per chunked table and one B9
    element pass per element table, nothing else."""
    return merged({k: rings * v for k, v in D.tables().items()})


def dist_product(label, D, x, refs, *, transpose=False, rings=1,
                 tol=TOL32) -> dict:
    """One product of ``D`` with its exact launches, held against each
    ``(name, reference)`` within ``tol``."""
    reset_counts()
    y = D.apply(x, transpose=transpose)
    torch.cuda.synchronize()
    got = counts()
    want = dist_want(D, rings)
    require(got == want, f"{label}: launches {got}, expected {want}")
    errs = [rel_check(f"{label} vs {name}", y, ref, tol) for name, ref in refs]
    print(f"  {label}: launches { {k: v for k, v in got.items() if v} } "
          f"(= the non-empty per-shard tables x {rings} ring(s))")
    return {"launches": {k: v for k, v in got.items() if v},
            "max_abs_err": max(errs)}


def dist_times(label, D, single, x, card) -> dict:
    """Eager and CUDA-graph ms of ``D @ x`` beside the single operator's
    default route and its bound (``product_bound``)."""
    eager = min(median_ms(lambda: D @ x), median_ms(lambda: D @ x))
    single_eager = median_ms(lambda: single @ x)
    try:
        graph = graph_ms(lambda: D @ x)
    except RuntimeError as e:
        if isinstance(e, SmokeFailure):  # a replay off the eager product
            raise
        torch.cuda.synchronize()
        graph = None
        print(f"  {label}: D @ x does not capture in a CUDA graph "
              f"({str(e).splitlines()[0][:120]})")
    single_graph = graph_ms(lambda: single @ x)
    bnd = product_bound(single)
    print(f"  {label}: D @ x eager {eager:.4f} ms, graph "
          + ("not captured" if graph is None else f"{graph:.4f} ms")
          + f"; the single operator's default route ({stream_kernel(single)}"
          f") eager {single_eager:.4f} ms, graph {single_graph:.4f} ms; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}) [{card}]")
    return {"ms": eager, "graph_ms": graph, "single_ms": single_eager,
            "single_graph_ms": single_graph, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


def wall_ms(fn, reps: int = 20) -> float:
    """Median host-clock ms of ``fn`` ending in a synchronize of every
    card this process sees (a product that spans cards: no single CUDA
    event pair or graph covers it)."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    fn()
    sync()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def multi_device_paths(S_op, x, card) -> dict:
    """The transports one card cannot run, on phase 12's BEM: its shards
    on every card of this process (cross-device copies), and one process
    per card over NCCL (NCCL refuses two ranks on one GPU).  They run where
    ``torch.cuda.device_count() >= 2`` (``--mesh`` runs them alone);
    otherwise they are reported as not run, with the reason."""
    ndev = torch.cuda.device_count()
    if ndev < 2:
        why = (f"torch.cuda.device_count() = {ndev}: the cross-device "
               "in-process copy needs two cards, and NCCL refuses two ranks "
               "on one GPU; the process-group transport is held by "
               "tests/test_torch_multihost.py over gloo on the CPU")
        print(f"  not run: the cross-device and NCCL transports ({why})")
        return {"cross_device": "not run", "nccl": "not run", "why": why}
    out = {"cards": ndev}
    D = distribute(S_op, Mesh([torch.device("cuda", i) for i in range(ndev)]))
    X = torch.randn((S_op.shape[0], 64),
                    generator=torch.Generator().manual_seed(16)).to(DEV)
    for label, v, tr in (("D @ x", x, False), ("D.T @ x", x, True),
                         ("D @ X r=64", X, False)):
        reset_counts()
        y = D.apply(v, transpose=tr)
        for i in range(ndev):
            torch.cuda.synchronize(i)
        got = counts()
        require(got == dist_want(D), f"BEM {label} over {ndev} cards: "
                f"launches {got}, expected {dist_want(D)}")
        out[label] = rel_check(f"BEM {label} over {ndev} cards in one "
                               f"process", y, S_op.apply(v, transpose=tr),
                               TOL32)
    out["ms"] = wall_ms(lambda: D @ x)
    out["single_ms"] = wall_ms(lambda: S_op @ x)
    print(f"  BEM D @ x over {ndev} cards in one process: {out['ms']:.4f} ms "
          f"eager (host clock to the last card's synchronize), the single "
          f"operator {out['single_ms']:.4f} ms; {D.tables()} [{card}]")
    del D
    port = 29500 + os.getpid() % 1000
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--nccl-worker", str(rank), str(ndev),
                               str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for rank in range(ndev)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        require(p.returncode == 0 and f"rank {rank}: OK" in o,
                f"NCCL worker {rank} failed:\n{o[-3000:]}")
        print("  " + o.strip().splitlines()[-1])
    out["nccl"] = outs[0].strip().splitlines()[-1]
    return out


def nccl_worker(rank: int, nproc: int, port: str) -> int:
    """One rank of the NCCL check (``--nccl-worker``): phase 12's BEM
    operator sharded over every rank's card, ``D @ x``, ``D.T @ x`` and
    ``D @ X`` against the single operator on this rank's card, and the
    eager ms of ``D @ x``."""
    torch.cuda.set_device(rank % torch.cuda.device_count())
    multihost.init(f"127.0.0.1:{port}", nproc, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    S_op = bt.SymmetricBlockMatrix(
        *bem_system(BEM_NPTS, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM),
        device=dev)
    D = distribute(S_op, multihost.global_row_mesh())
    rng = np.random.default_rng(15)
    x = multihost.replicate(rng.standard_normal(BEM_NPTS).astype(np.float32),
                            D.mesh)
    X = multihost.replicate(rng.standard_normal((BEM_NPTS, 64)).astype(
        np.float32), D.mesh)
    errs = [rel_check(f"rank {rank}: BEM {label} over NCCL",
                      D.apply(v, transpose=tr), S_op.apply(v, transpose=tr),
                      TOL32)
            for label, v, tr in (("D @ x", x, False), ("D.T @ x", x, True),
                                 ("D @ X r=64", X, False))]
    ms = wall_ms(lambda: D @ x)
    print(f"rank {rank}: OK (max_abs_err {max(errs):.3e}; D @ x {ms:.4f} ms "
          f"eager over {nproc} processes, host clock)", flush=True)
    torch.distributed.destroy_process_group()
    return 0


def phase15(card: str) -> dict:
    print("phase 15: the distributed layer (parallel/): block-row shards on "
          f"{DEV}, each shard's groups through B1 and B9's element pass")
    t_phase = time.perf_counter()
    out = {"operands": {}, "launches": {"B1": 0, "B9 element": 0}}
    gen = torch.Generator().manual_seed(15)
    n = BEM_NPTS

    def operand(key, single, S, build_s, mesh=None, **kw):
        t = time.perf_counter()
        D = distribute(single, mesh or Mesh([DEV] * S), **kw)
        torch.cuda.synchronize()
        ctor = time.perf_counter() - t
        print(f"  {key}: {D}; {D.tables()} per ring; exchanged_bytes_per_"
              f"call {D.exchanged_bytes_per_call}; construction {ctor:.2f} s "
              f"(the single operator {build_s:.2f} s)")
        rec = out["operands"].setdefault(key, {"products": {}})
        rec.update(S=S, construction_s=ctor, single_construction_s=build_s,
                   exchanged_bytes_per_call=D.exchanged_bytes_per_call)
        return D, rec

    def product(rec, label, D, x, refs, **kw):
        res = dist_product(label, D, x, refs, **kw)
        rec["products"][label] = res
        for k in out["launches"]:
            out["launches"][k] += res["launches"].get(k, 0)

    def built(fn):
        t = time.perf_counter()
        op = fn()
        torch.cuda.synchronize()
        return op, time.perf_counter() - t

    # BEM n = 8192 (phase 12's operator) on 4 shards
    args = bem_system(BEM_NPTS, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM)
    S_op, build_s = built(lambda: bt.SymmetricBlockMatrix(*args, device=DEV))
    D, rec = operand("BEM n=8192", S_op, DIST_SHARDS["bem"], build_s)
    x = torch.randn(n, generator=gen).to(DEV)
    X = torch.randn((n, 64), generator=gen).to(DEV)
    for label, v, tr in (("D @ x", x, False), ("D.T @ x", x, True),
                         ("D @ X r=64", X, False)):
        product(rec, f"BEM {label}", D, v, [
            ("the single operator", S_op.apply(v, transpose=tr)),
            ("float64 plain route", plain_route_sym(
                S_op, v, transpose=tr, dtype=torch.float64))], transpose=tr)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(
        np.float32)).to(DEV)
    xs, info_s = bt.cg(S_op, b, tol=SOLVE_TOL)
    reset_counts()
    solvers.HOST_CHECKS = 0
    xd, info_d = bt.cg(D, b, tol=SOLVE_TOL)
    torch.cuda.synchronize()
    got, reads = counts(), solvers.HOST_CHECKS
    k, ks = int(info_d.iterations), int(info_s.iterations)
    restart = inspect.signature(bt.gmres).parameters["restart"].default
    want_reads, nS, _ = solve_products("cg", k, restart)
    require(bool(info_d.converged) and abs(k - ks) <= 1,
            f"cg through D: {k} iterations (converged {bool(info_d.converged)})"
            f", the single operator {ks}")
    require(reads == want_reads and got == dist_want(D, nS),
            f"cg through D: {reads} reads, launches {got}; expected "
            f"{want_reads} reads and {nS} products")
    err = rel_check("cg through D: x vs the single operator's solution", xd,
                    xs, TOL32)
    print(f"  cg through D, tol {SOLVE_TOL}: {k} iterations (the single "
          f"operator {ks}), {reads} host reads, {nS} products, launches "
          f"{ {k_: v for k_, v in got.items() if v} }")
    for key in out["launches"]:
        out["launches"][key] += got[key]
    rec["cg"] = {"iterations": k, "single_iterations": ks, "x_err": err,
                 "launches": {k_: v for k_, v in got.items() if v}}
    args64 = [[a.astype(np.float64) for a in args[0]], args[1],
              [a.astype(np.float64) for a in args[2]], *args[3:]]
    S64, build64 = built(lambda: bt.SymmetricBlockMatrix(*args64, device=DEV))
    D64, rec64 = operand("BEM n=8192 float64", S64, DIST_SHARDS["bem"],
                         build64)
    x64 = torch.randn(n, generator=gen, dtype=torch.float64).to(DEV)
    product(rec64, "BEM float64 D @ x", D64, x64, [
        ("scipy", bt.to_scipy(S64) @ x64.cpu().numpy())],
        tol=TOL[torch.float64])
    rec["times"] = dist_times("BEM n=8192", D, S_op, x, card)
    out["multi_device"] = multi_device_paths(S_op, x, card)
    del D, D64, S64

    # the same BEM on scattered index lists: element groups, B9
    perm = np.random.default_rng(14).permutation(n)
    Ss, build_s = built(lambda: bt.SymmetricBlockMatrix(
        *bem_system(BEM_NPTS, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM,
                    perm=perm), device=DEV, schedule="serial"))
    Ds, recs = operand("BEM n=8192 scattered", Ss, DIST_SHARDS["bem"],
                       build_s)
    require(Ds.tables()["B9 element"] > 0, "the scattered BEM has no element "
            "groups")
    product(recs, "scattered BEM D @ x", Ds, x, [
        ("the single operator", Ss @ x),
        ("float64 plain route", plain_route_sym(Ss, x, dtype=torch.float64))])
    recs["times"] = dist_times("scattered BEM", Ds, Ss, x, card)
    del Ds, Ss, S_op

    # config 1 (phase 3's operand) on 4 shards, and a 4 x 2 rhs mesh
    A, build_s = built(lambda: contiguous_operator(
        *DIST_CONFIG1, seed=7, value_seed=7 + 7777, device=DEV)[0])
    n = A.shape[0]
    x = torch.randn(n, generator=gen).to(DEV)
    D, rec = operand("config 1", A, DIST_SHARDS["config 1"], build_s)
    X = torch.randn((n, 128), generator=gen).to(DEV)
    for label, v, tr in (("D @ x", x, False), ("D.T @ x", x, True),
                         ("D @ X r=128", X, False)):
        product(rec, f"config 1 {label}", D, v, [
            ("the single operator", A.apply(v, transpose=tr)),
            ("float64 plain route", plain_route(A, v, transpose=tr,
                                                dtype=torch.float64))],
            transpose=tr)
    mesh2 = Mesh(np.array([DEV] * 8, dtype=object).reshape(4, 2),
                 ("rows", "rhs"))
    D2, rec2 = operand("config 1, 4 x 2 rhs mesh", A, 4, build_s,
                       mesh=mesh2, rhs_axis="rhs")
    X6 = torch.randn((n, 6), generator=gen).to(DEV)
    for label, tr in (("D @ X r=6", False), ("D.T @ X r=6", True)):
        product(rec2, f"config 1 on the 4 x 2 rhs mesh {label}", D2, X6, [
            ("the single operator", A.apply(X6, transpose=tr)),
            ("float64 plain route", plain_route(A, X6, transpose=tr,
                                                dtype=torch.float64))],
            transpose=tr, rings=2)
    rec["times"] = dist_times("config 1", D, A, x, card)
    del D, D2, A

    # config 3 VBCRS n = 32768 on 8 shards
    n3 = DIST_CONFIG3_N
    blocks, rs, cs = config3_blocks(n3)
    V, build_s = built(lambda: bt.VariableBlockCompressedRowStorage(
        blocks, rs, cs, (n3, n3), granularity=(8, 128), device=DEV))
    D, rec = operand("config 3", V, DIST_SHARDS["config 3"], build_s)
    x3 = torch.randn(n3, generator=gen).to(DEV)
    product(rec, "config 3 D @ x", D, x3, [
        ("the single operator", V @ x3),
        ("float64 plain route", plain_route(V, x3, dtype=torch.float64))])
    rec["times"] = dist_times("config 3", D, V, x3, card)
    del D, V
    require(all(out["launches"].values()),
            f"phase 15 skipped B1 or B9's element pass: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 15: launches {out['launches']}; {out['seconds']:.1f} s")
    return out


# -- phase 16 ------------------------------------------------------------------

# the route a launched kernel belongs to ("B2 prologue" rides with B2)
ROUTE_OF = {"B1": "bucket", "B9 element": "bucket", "B9 gather": "bucket",
            "B9 owner": "bucket", "B9 colored": "bucket",
            "B9 rounds": "bucket", "B5": "panel", "B10": "panel", "B8": "slab",
            "B7": "patch", "B2": "patch", "B3": "patch"}
AUTOTUNE_CASES = (("bsm", 1), ("bsm", 128), ("sym", 1), ("sym", 128),
                  ("vbcrs", 1))


def routes_run(grown: dict) -> set:
    """The routes whose kernels a product launched."""
    return {ROUTE_OF[k] for k, v in grown.items() if v and k in ROUTE_OF}


def route_want(op, route: str, r: int) -> dict:
    """Exact launches of the route's own kernels in one f32 product
    ``op @ X[:, :r]`` that takes ``route``."""
    if route == "bucket":
        want = bucket_want(op, r=r)
        return {k: want[k] for k in ("B1", "B1 sym", "B9 element",
                                     "B9 element sym", "B9 colored",
                                     "B9 rounds")}
    if route in ("panel", "slab"):
        plan = op._staged("panel" if route == "panel" else "strip",
                          False)[0]
        name = ("B8" if route == "slab" else
                "B10" if isinstance(plan, panel2.Panel2Plan) else "B5")
        return {name: 1, f"{name} mirror": int(bool(plan.mirror))}
    if r == 1:
        return {"B7": 1}
    return {"B3": 1} if hasattr(op, "_dlayout") else {"B2": 1,
                                                      "B2 prologue": 1}


def routed_once(label, op, x, route, r) -> dict:
    """One product of ``op`` with the counters reset: the launches, held
    to exactly ``route``'s kernels."""
    reset_counts()
    op @ x
    torch.cuda.synchronize()
    grown = counts()
    require(routes_run(grown) == {route},
            f"{label}: the product ran {routes_run(grown)}, not {route}: "
            f"{grown}")
    require_counts(label, grown, route_want(op, route, r))
    return grown


def phase16(card: str, defaults: dict | None = None) -> dict:
    print("phase 16: autotune -- every route open to an operator timed on "
          "the card (utils/autotune.autotune_backend), the winner recorded "
          "per population and routing the next product; config 1 (n = 8192) "
          "and the symmetric real size (n = 32768) at r = 1 and 128, the "
          "VBCRS real size (n = 32768) at r = 1; save / load of each; "
          "autotune_optimize on config 1 at r = 128")
    t_phase = time.perf_counter()
    ops = {key: (defaults or {}).get(key) or real_operand(key)[0]
           for key in ("bsm", "sym", "vbcrs")}
    gen = torch.Generator().manual_seed(16)
    out = {"cases": {}, "errs": {}, "launches": Counter(), "roundtrip": {}}
    tune_s = 0.0
    for key, r in AUTOTUNE_CASES:
        op, label = ops[key], f"{REAL[key]}, r = {r}"
        n = op.shape[1]
        x = (real_x(key) if r == 1
             else torch.randn((n, r), generator=gen).to(DEV))
        reset_counts()
        op @ x
        torch.cuda.synchronize()
        (rule,) = routes_run(counts())
        t0 = time.perf_counter()
        report = autotune.autotune_backend(op, r)
        torch.cuda.synchronize()
        tune_s += time.perf_counter() - t0
        require(report["applied"] and len(report["times_us"]) > 1,
                f"{label}: autotune did not apply: {report}")
        graph = {route: graph_ms(lambda B=autotune._pinned_copy(op, route):
                                 B @ x)
                 for route in report["times_us"]}
        winner = report["winner"]
        for route, us in report["times_us"].items():
            print(f"  {label}: {route:6s} chained {us:9.2f} us, graph "
                  f"{graph[route]:.4f} ms"
                  f"{' <- winner' if route == winner else ''}"
                  f"{' <- v5e rules' if route == rule else ''} [{card}]")
        grown = routed_once(f"{label}: tuned product", op, x, winner, r)
        out["launches"].update(grown)
        y = op @ x
        out["errs"][f"{key} r={r}"] = rel_check(
            f"{label}: the winner's product ({winner}) vs the float64 plain "
            "route", y, float64_reference(op, x), TOL32)
        out["cases"][f"{key} r={r}"] = {
            "times_us": report["times_us"], "graph_ms": graph,
            "rule": rule, "winner": winner, "differs": winner != rule}
        print(f"  {label}: v5e rules pick {rule}, autotune picks {winner}"
              f"{' (differs)' if winner != rule else ''}")
    print(f"  autotune_backend: {tune_s:.1f} s for {len(AUTOTUNE_CASES)} "
          "cases")
    for key, op in ops.items():
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{key}.npz")
            t0 = time.perf_counter()
            bt.save(path, op)
            t1 = time.perf_counter()
            dispatch._POPULATION_POLICY.clear()  # as in a new process
            loaded = bt.load(path, device=DEV)
            t2 = time.perf_counter()
        for k, r in AUTOTUNE_CASES:
            if k != key:
                continue
            case = out["cases"][f"{key} r={r}"]
            x = (real_x(key) if r == 1 else
                 torch.randn((op.shape[1], r), generator=gen).to(DEV))
            out["launches"].update(routed_once(
                f"{REAL[key]}, r = {r}: loaded product", loaded, x,
                case["winner"], r))
        out["roundtrip"][key] = {"save_s": t1 - t0, "load_s": t2 - t1}
        print(f"  {REAL[key]}: save {t1 - t0:.2f} s, load {t2 - t1:.2f} s; "
              "the loaded operator routes to the saved winners")
        del loaded
    A = ops["bsm"]
    X = torch.randn((A.shape[1], 128), generator=gen).to(DEV)
    t0 = time.perf_counter()
    rep = autotune.autotune_optimize(A, 128)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    require(A._optimize == rep["winner"] and (
        rep["applied"] or rep["plans"]["latency"]
        == rep["plans"]["throughput"]), f"autotune_optimize: {rep}")
    for opt, plan in rep["plans"].items():
        us = rep[f"{opt}_us"]
        print(f"  config 1 r = 128, optimize={opt!r}: G {plan['G']}, "
              f"{plan['steps']} steps, {plan['slots']} slots of which "
              f"{plan['padded_slots']} padding; B2 chained "
              + (f"{us:.2f} us" if us is not None else "not timed (the "
                 "latency plan's)") + f" [{card}]")
    print(f"  autotune_optimize: winner {rep['winner']!r}, applied "
          f"{rep['applied']}{'; ' + rep['note'] if 'note' in rep else ''}")
    reset_counts()
    Y = A @ X
    torch.cuda.synchronize()
    require_counts("config 1 r = 128 under the winning bias", counts(),
                   {"B2": 1, "B2 prologue": 1})
    out["errs"]["optimize"] = rel_check(
        f"config 1 r = 128 under optimize={rep['winner']!r} vs the float64 "
        "plain route", Y, float64_reference(A, X), TOL32)
    out["optimize"] = {**rep, "seconds": opt_s}
    out["tune_s"] = tune_s
    print(f"  autotune_optimize: {opt_s:.1f} s; phase 16 "
          f"{time.perf_counter() - t_phase:.1f} s")
    dispatch._POPULATION_POLICY.clear()
    return out


def transpose_times(card: str) -> dict:
    """The transposed products of this checkout's B2, timed alone (eager
    and from a CUDA graph, at both tiers): A.T @ X on phase 3's operand (an
    operator built with each precision) and batched_mm's dX at phase 9's
    real size (P = 4).  Only entry points that older checkouts of the port
    also have are used (the operators' .T and their ``precision``,
    batched_spmm's transpose mode), so this script, copied into an older
    checkout, times its transposes the same way (``--transposes``)."""
    gen = torch.Generator(device="cpu").manual_seed(9)
    X = torch.randn((8192, 128), generator=gen).to(DEV)
    out = {}
    for prec in ("highest", None):
        A, _ = contiguous_operator(8192, 2000, 128, seed=7,
                                   value_seed=7 + 7777, device=DEV,
                                   precision=prec)
        fn = lambda A=A: A.T @ X  # noqa: E731
        out[f"A.T @ X {prec}"] = (median_ms(fn), graph_ms(fn))
        del A, fn
    ops = config1_operators(8192, 2000, 128, 4)
    _plan, vals_b, cc, rs = batched._stacked_entry(ops)
    G = torch.randn((4, 8192, 128), generator=gen).to(DEV)
    for prec in ("highest", None):
        fn = lambda p=prec: batched_spmm.batched_spmm(  # noqa: E731
            vals_b, cc, rs, G, 8192, transpose=True, precision=p)
        out[f"batched_mm dX P=4 {prec}"] = (median_ms(fn), graph_ms(fn))
    for k, (eager, graph) in out.items():
        print(f"  {k}: eager {eager:.4f} ms, graph {graph:.4f} ms [{card}]")
    return out


def spmv_times(card: str) -> dict:
    """The r = 1 stream products of this checkout's B5, B6, B7 and B10,
    timed alone, eager and from a CUDA graph: phase 3's, 5's and 7's
    operands through their routes (``op @ x``, each checked against the
    plain version on the plan it reads), the gradient of each
    (:func:`grad_times`), the symmetric operand's fused and expanded
    candidate plans through B5 directly; the same operands built with
    ``patch="always"`` (B7, and ``A.T @ x`` on config 1) and with
    ``panel="v2"`` (B10); and ``batched_mv`` (B6) on phase 9's config-2
    and config-3 batches.  Only entry points that older checkouts of the
    port also have are used, so this script, copied into an older checkout,
    times its kernels the same way (``--spmv``)."""
    gen = torch.Generator(device="cpu").manual_seed(41)
    A, _ = contiguous_operator(8192, 2000, 128, seed=7, value_seed=7 + 7777,
                               device=DEV)
    d, di, o, ri, ci, shape = random_symmetric(
        8, n=32768, ngroups=384, noffdiag=4096, dtype=np.float32,
        contiguous=True)
    S = bt.SymmetricBlockMatrix(d, di, o, ri, ci, shape, device=DEV)
    blocks, rs, cs = config3_blocks(32768)
    V = bt.VariableBlockCompressedRowStorage(
        blocks, rs, cs, (32768, 32768), granularity=(8, 128), device=DEV)
    out = {}
    for key, op in (("config 1", A), ("symmetric", S), ("VBCRS", V)):
        x = torch.randn(op.shape[1], generator=gen).to(DEV)
        choice, plan, dev = op._stream_entry(False)
        require(choice == "panel", f"{key}: the SpMV takes {choice}")
        rel_check(f"{key} SpMV vs plain", op @ x,
                  panel_spmv.panel_apply_plain(plan, dev, x), TOL32)
        fn = lambda op=op, x=x: op @ x  # noqa: E731
        out[key] = {"plan": describe(plan), "eager_ms": median_ms(fn),
                    "graph_ms": graph_ms(fn),
                    "grad": grad_times(key, op, x, card)}
        print(f"  {key} SpMV: {out[key]['plan']}: eager "
              f"{out[key]['eager_ms']:.4f} ms, graph {out[key]['graph_ms']:.4f}"
              f" ms [{card}]")
        if key == "symmetric":
            entries = (_layout_entries(S._dlayout, transpose=False),
                       _layout_entries(S._olayout, transpose=False),
                       _layout_entries(S._olayout, transpose=True))
            cands = {
                "fused": _best_shift_variant(
                    entries[0] + [(b, r, c, True) for b, r, c, _ in entries[1]],
                    shape, mirror=True, TS_max=1024),
                "expanded": _best_shift_variant(
                    entries[0] + entries[1] + entries[2], shape, mirror=False,
                    TS_max=1024)}
            for name, cplan in cands.items():
                cdev = panel_spmv.panel_device_arrays(cplan, DEV)
                fn = lambda p=cplan, dv=cdev, x=x: panel_spmv.panel_spmv(p, dv, x)  # noqa: E731
                rel_check(f"B5 on the {name} plan vs plain", fn(),
                          panel_spmv.panel_apply_plain(cplan, cdev, x), TOL32)
                out[f"symmetric {name}"] = {
                    "plan": describe(cplan), "eager_ms": median_ms(fn),
                    "graph_ms": graph_ms(fn)}
                print(f"  symmetric {name} plan through B5: "
                      f"{out[f'symmetric {name}']['plan']}: eager "
                      f"{out[f'symmetric {name}']['eager_ms']:.4f} ms, graph "
                      f"{out[f'symmetric {name}']['graph_ms']:.4f} ms [{card}]")
                del cdev, fn
    del A, S, V
    # the opt-in routes: B7 (patch="always") and B10 (panel="v2")
    for key, make in (("config 1", "bsm"), ("symmetric", "sym"),
                      ("VBCRS", "vbcrs")):
        x = torch.randn(8192 if make == "bsm" else 32768,
                        generator=gen).to(DEV)
        op = real_operand(make, patch="always")[0]
        plan, dev = op._patch_for(False) if make == "sym" else op._patch_for()
        products = {f"{key} B7": (lambda op=op: op @ x,
                                  lambda p=plan, d=dev: (
                                      patch_engine.patch_spmv_plain(p, d, x)))}
        if make == "bsm":
            products[f"{key} A.T @ x B7"] = (
                lambda op=op: op.T @ x,
                lambda p=plan, d=dev: patch_engine.patch_spmv_plain(
                    p, d, x, transpose=True))
        v2 = real_operand(make, panel="v2")[0]
        choice, p2, d2 = v2._stream_entry(False)
        require(isinstance(p2, panel2.Panel2Plan),
                f"{key}: panel='v2' must take a v2 plan, took {choice}")
        products[f"{key} B10"] = (
            lambda op=v2: op @ x,
            lambda p=p2, d=d2: panel2_spmv.panel2_apply_plain(p, d, x))
        for name, (fn, plain) in products.items():
            rel_check(f"{name} vs plain", fn(), plain(), TOL32)
            out[name] = {"eager_ms": median_ms(fn), "graph_ms": graph_ms(fn)}
            print(f"  {name}: eager {out[name]['eager_ms']:.4f} ms, graph "
                  f"{out[name]['graph_ms']:.4f} ms [{card}]")
        del op, plan, dev, v2, p2, d2, products
    for key, ops in (("batched_mv config 2 P=16", config2_operators(16)),
                     ("batched_mv config 3 P=16", config3_operators(4096, 16))):
        xb = torch.randn((16, 4096), generator=gen).to(DEV)
        fn = lambda ops=ops, xb=xb: bt.batched_mv(ops, xb)  # noqa: E731
        out[key] = {"eager_ms": median_ms(fn), "graph_ms": graph_ms(fn)}
        print(f"  {key} (B6): eager {out[key]['eager_ms']:.4f} ms, graph "
              f"{out[key]['graph_ms']:.4f} ms [{card}]")
    return out


def print_rooflines(summary: dict, card: str) -> None:
    """Each kernel's timed product beside its bound and its library call,
    one line each (the numbers of the kernels line)."""
    print(f"kernels against their bounds and library calls [{card}]:")
    for k in summary["kernels"]:
        graph = k.get("graph_ms")
        share = f"{100 * k['bound_ms'] / graph:.1f}%" if graph else "-"
        lib = k["library_ms"]
        lib_txt = "none" if lib is None else (
            f"{lib:.4f} eager / " + ("no graph" if k["library_graph_ms"] is None
                                     else f"{k['library_graph_ms']:.4f} graph"))
        graph_txt = f"{graph:.4f}" if graph else "-"
        print(f"  {k['name']}: {k['launches']} launches; eager {k['ms']:.4f} "
              f"ms, graph {graph_txt} ms, bound {k['bound_ms']:.4g} ms "
              f"({k['bound_by']}) = {share} of the graph time; library call "
              f"{lib_txt} ms; plain {k['plain_ms']:.4f} ms; timed: "
              f"{k.get('timed', '')}")


def instance_types(args: str) -> str:
    """The stored -> compute types of a tile-core instance from the
    mangled template arguments before its column tile."""
    if "bfloat16" in args:
        return "bf16->f64" if args.endswith("d") else "bf16->f32"
    if "cplxIf" in args:
        return "c64->c128" if "IdEE" in args else "complex64"
    if "cplxId" in args:
        return "complex128"
    return {"ff": "float32", "dd": "float64", "fd": "f32->f64"}.get(args,
                                                                     args)


def print_complex_builds(out: str) -> dict:
    """ptxas's registers and spill stores of B1's and B9's complex and
    mixed instances (tile_core.cuh::bucket_kernel over cplx<float> /
    cplx<double>, and the stored / compute pairs bf16 -> f32 / f64, f32 ->
    f64, c64 -> c128), one line per kernel, types and column tile, of the
    tensor-core instances and the owner passes, and (registers, spills and
    stack) of the row-stream body's kernels (row_stream.cuh::row_kernel,
    every pair and mode, one line per map); returns them."""
    found = {}
    for part in out.split("Compiling entry function")[1:]:
        inst = re.match(r" '\w*bucket_kernelI(\w+?)Li(\d+)ELb\dELb\dELb\dE"
                        r"\w*?(ChunkMap|ElemMap)", part)
        used = re.search(r"Used (\d+) registers", part)
        if inst and used:
            types = instance_types(inst.group(1))
            if types in ("float32", "float64"):
                continue
            spill = re.search(r"(\d+) bytes spill stores", part)
            found.setdefault((types, inst.group(2), inst.group(3)), []).append(
                (int(used.group(1)), int(spill.group(1)) if spill else 0))
    names = {"ChunkMap": "B1", "ElemMap": "B9 element pass"}
    for (t, tr, kind), regs in sorted(found.items(),
                                      key=lambda kv: (kv[0][2], kv[0][0],
                                                      int(kv[0][1]))):
        print(f"ptxas: {names[kind]} {t} TR={tr}: {len(regs)} "
              f"instances, {min(u for u, _ in regs)}-{max(u for u, _ in regs)}"
              f" registers, {sum(sp for _, sp in regs)} bytes of spill stores")
    for label, pat in (("B9 owner products pass", "owner_products_kernel"),
                       ("B9 owner sum pass", "owner_sum_kernel"),
                       ("B1 complex64 tensor cores", "PolicyC64"),
                       ("B1 float64 tensor cores", "PolicyF64"),
                       ("B1 complex128 tensor cores", "PolicyC128"),
                       ("B1 bf16->f32 tensor cores", "PolicyBF16")):
        regs = [(int(u.group(1)), int(sp.group(1)) if sp else 0,
                 part.split("\n")[0])
                for part in out.split("Compiling entry function")[1:]
                if pat in part.split("\n")[0]
                for u, sp in [(re.search(r"Used (\d+) registers", part),
                               re.search(r"(\d+) bytes spill stores", part))]
                if u]
        if not regs:
            continue
        wn = sorted({m.group(1) for _, _, h in regs
                     for m in [re.search(r"Policy\w+?ELi(\d)E", h)] if m})
        print(f"ptxas: {label}: {len(regs)} instances, "
              f"{min(u for u, _, _ in regs)}-{max(u for u, _, _ in regs)} "
              f"registers, {sum(sp for _, sp, _ in regs)} bytes of spill "
              f"stores" + (f" (WN {', '.join(wn)})" if wn else ""))
    rows = {}
    for part in out.split("Compiling entry function")[1:]:
        inst = re.match(r" '\w*row_kernelI(\w+?)Li(\d)ELb(\d)E\w*?"
                        r"(ChunkMap|ElemMap)", part)
        used = re.search(r"Used (\d+) registers", part)
        if inst and used:
            spill = re.search(r"(\d+) bytes spill stores", part)
            stack = re.search(r"(\d+) bytes stack frame", part)
            rows[(inst.group(4), instance_types(inst.group(1)),
                   int(inst.group(2)), inst.group(3))] = (
                int(used.group(1)), int(spill.group(1)) if spill else 0,
                int(stack.group(1)) if stack else 0)
    names = {"ChunkMap": "B1", "ElemMap": "B9 element pass"}
    for kind in ("ChunkMap", "ElemMap"):
        per = sorted((k[1:], v) for k, v in rows.items() if k[0] == kind)
        if per:
            print(f"ptxas: row-stream body, {names[kind]}: " + "; ".join(
                f"{t} mode {m}{' conj' if c == '1' else ''} {u} registers"
                f"{f', {sp} bytes spilled' if sp else ''}"
                f"{f', {st} bytes of stack' if st else ''}"
                for (t, m, c), (u, sp, st) in per))
    found["row-stream"] = rows
    return found


def main() -> None:
    if sys.argv[1:2] == ["--nccl-worker"]:
        sys.exit(nccl_worker(*map(int, sys.argv[2:4]), sys.argv[4]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}, tf32 off")
    t0 = time.perf_counter()
    build.load_library()
    info = build.build_info()
    print(f"kernel library {info['library']}: nvcc {info['build_s']:.1f} s, "
          f"load {time.perf_counter() - t0:.1f} s")
    out = info.get("compiler_output", "")
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", out)]
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", out))
    if regs:
        print(f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers "
              f"per thread, {spills} bytes of spill stores in all")
    tr_builds = {}  # B2's transpose: its <TR, TIER> instances
    for part in out.split("Compiling entry function")[1:]:
        inst = re.match(r" '\w*patch_tr_kernelILi(\d+)ELi(\d)E", part)
        used = re.search(r"Used (\d+) registers", part)
        if inst and used:
            spill = re.search(r"(\d+) bytes spill stores", part)
            tr_builds[inst.groups()] = (used.group(1),
                                        spill.group(1) if spill else "0")
    for (TR, tier), (used, spill) in sorted(tr_builds.items()):
        print(f"ptxas: B2 transpose TR={TR} tier {tier}: {used} registers, "
              f"{spill} bytes of spill stores")
    print_complex_builds(out)
    if out:
        print(f"ptxas: {out.count('C7519')} wgmma fences injected (C7519)")
    if sys.argv[1:] == ["--transposes"]:
        print(f"transposes of the port at {bt.__file__}")
        print(json.dumps({"transposes": transpose_times(card)}))
        return
    if sys.argv[1:] == ["--spmv"]:
        print(f"r = 1 stream products of the port at {bt.__file__}")
        print(json.dumps({"spmv": spmv_times(card)}))
        return
    if sys.argv[1:] == ["--solve"]:
        print(json.dumps({"solve": phase12(card)}, default=str))
        return
    if sys.argv[1:] == ["--complex"]:
        print(json.dumps({"complex": phase13(card)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--mesh"]:
        S_op = bt.SymmetricBlockMatrix(
            *bem_system(BEM_NPTS, BEM_CLUSTERS, BEM_THRESH, BEM_SELF_TERM),
            device=DEV)
        x = torch.randn(BEM_NPTS, generator=torch.Generator().manual_seed(
            15)).to(DEV)
        print(json.dumps({"mesh": multi_device_paths(S_op, x, card)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--distributed"]:
        print(json.dumps({"distributed": phase15(card)}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--autotune"]:
        print(json.dumps({"autotune": phase16(card)}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    for part in out.split("Compiling entry function")[1:]:
        name = re.match(r" '\w*?((?:products_r1|rounds)_kernel\w*)'", part)
        used = re.search(r"Used (\d+) registers", part)
        if name and used:
            spill = re.search(r"(\d+) bytes spill stores", part)
            print(f"ptxas: B9 colored {name.group(1)[:56]}: {used.group(1)} "
                  f"registers, {spill.group(1) if spill else 0} bytes "
                  f"spilled")
    if sys.argv[1:] == ["--colored"]:
        gen = torch.Generator(device="cpu").manual_seed(5)
        errs = {**rounds_vs_plain(gen), **colored_vs_plain(gen)}
        sc = scattered_main_path(card)
        x = torch.randn(4096, generator=gen).to(DEV)
        Sf = bt.SymmetricBlockMatrix(*random_symmetric(
            8, n=4096, ngroups=48, noffdiag=160, dtype=np.float32,
            contiguous=False), device=DEV)
        single = b9_single_calls(Sf, x, gen, card)
        real = colored_real_size(card)
        print(json.dumps({"colored": {"errs": errs, "flagship": sc,
                                      "real": real, "single": single}},
                         default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--options"]:
        opts = phase14(card)
        print(json.dumps({"kernels": opts["kernels"]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    wall = {}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        wall[name] = time.perf_counter() - t
        print(f"  [{name}: {wall[name]:.1f} s wall]")
        return out

    errs1 = run("phase 1", phase1)
    errs2, launches = run("phase 2", phase2)
    times = run("phase 3", phase3, card)
    b2 = times["B2"]
    errs4, launches4 = run("phase 4", phase4, card)
    sym_times, errs5, launches5 = run("phase 5", phase5, card)
    colored_real = run("phase 5 colored", colored_real_size, card)
    errs6, launches6 = run("phase 6", phase6)
    v_times, errs7 = run("phase 7", phase7, card)
    slab_times, errs8 = run("phase 8", phase8, card)
    batch = run("phase 9", phase9, card)
    defaults = {"bsm": times["op"], "sym": sym_times["op"],
                "vbcrs": v_times["op"]}
    b7 = run("phase 10", phase10, card, defaults)
    b10 = run("phase 11", phase11, card, defaults, b7["library"])
    solve = run("phase 12", phase12, card)
    cx = run("phase 13", phase13, card)
    opts = run("phase 14", phase14, card)
    dist = run("phase 15", phase15, card)
    tuned = run("phase 16", phase16, card, defaults)
    print("phase wall times: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in wall.items()))
    require(all(b7["launches"].values()) and all(b10["launches"].values()),
            f"a main path skipped B7 or B10: {b7['launches']}, "
            f"{b10['launches']}")
    b5_launches = {"BSM real size (phase 3)": times["launches"],
                   "symmetric flagship (phase 4)": launches4["B5"],
                   "symmetric real size (phase 5)": sym_times["launches"],
                   "VBCRS flagship (phase 6)": launches6["B5"],
                   "VBCRS real size (phase 7)": v_times["launches"],
                   "BEM solve, cg + block_jacobi (phase 12)":
                       solve["launches"]["B5"]}
    require(all(b5_launches.values()), f"a main path skipped B5: {b5_launches}")
    b4_launches = {k: v for k, v in batch["launches"].items()
                   if k.startswith("B4")}
    b6_launches = {k: v for k, v in batch["launches"].items()
                   if k.startswith("B6") and "mirror" not in k}
    require(all(b4_launches.values()) and all(b6_launches.values()),
            f"a batched main path skipped its kernel: {batch['launches']}")

    def measured(bnd, lib):
        """The keys every kernel entry carries beside its times."""
        return {"bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
                "library_graph_ms": getattr(lib, "graph", None)}

    def per_operand(res):
        """Phase 10's or 11's times of every operand, keyed by operand."""
        out = {}
        for key, t in res["times"].items():
            for k in ("ms", "plain_ms", "graph_ms", "plain_graph_ms", "b5_ms",
                      "b5_graph_ms", "plan_mb", "read_mb", "plan_s", "seg",
                      "t_ms", "t_plain_ms", "t_graph_ms", "t_plain_graph_ms",
                      "geometry"):
                if k in t:
                    out[f"{key}_{k}"] = t[k]
            out[f"{key}_bound_ms"] = t["bound"][0]
        return out

    mm, mv2, mv3 = batch["mm"], batch["mv config 2"], batch["mv config 3"]
    b3 = sym_times["B3 tiers"]
    split, single = sym_times["split"], sym_times["B9 single"]
    scattered = launches4["scattered"]
    b1_launches = {"flagship main path (phase 2)": launches["B1"],
                   "BSM real size bucket route (phase 3)":
                       times["bucket launches"]["B1"],
                   "symmetric real size bucket route (phase 5)":
                       launches5["B1"],
                   "VBCRS real size bucket route (phase 7)":
                       v_times["bucket launches"]["B1"]}
    if solve["launches"]["B1"]:  # the preconditioner on the bucket route
        b1_launches["BEM solve, cg + block_jacobi (phase 12)"] = (
            solve["launches"]["B1"])
    b1_launches["complex Helmholtz BEM products (phase 13)"] = (
        cx["launches"]["native"])
    b1_launches["complex Helmholtz BEM gmres + block_jacobi (phase 13)"] = (
        cx["launches"]["gmres64"])
    b1_launches["distributed products and cg: BEM, config 1, config 3 "
                "(phase 15)"] = dist["launches"]["B1"]
    element_launches = {
        "scattered symmetric main path, serial (phase 4)":
            scattered["serial"]["B9 element"],
        "symmetric real size bucket route (phase 5)":
            launches5["B9 element"],
        "scattered complex Helmholtz BEM products, serial (phase 13)":
            cx["launches"]["scattered"],
        "distributed scattered BEM product (phase 15)":
            dist["launches"]["B9 element"]}
    cx_times = {f"complex{suffix}_{key}": t[key]
                for label, suffix in (("S @ x", ""), ("S @ X r=16", "_r16"),
                                      ("S @ X", "_r64"))
                for t in (cx["times"][label],)
                for key in ("ms", "graph_ms", "plain_ms", "plain_graph_ms",
                            "split_ms", "split_graph_ms",
                            "split_launches", "bound_ms", "bound_by",
                            "library_ms", "library_graph_ms", "fma_ms",
                            "fma_graph_ms") if key in t}
    mma_t, mma16 = cx["times"]["S @ X"], cx["times"]["S @ X r=16"]
    require(all(b1_launches.values()) and all(element_launches.values()),
            f"a path skipped B1 or B9's element pass: {b1_launches}, "
            f"{element_launches}")
    capped = batch["mv capped"]
    summary = {"kernels": [
        {"name": "fused_spmm (B1)", "route": "cuda", "source": B1_SRC,
         "replaces": B1_REPLACES, "launches": launches["B1"],
         "launches_by_path": b1_launches,
         "design": "one launch per layout over a device table of bucket "
                   "descriptors (grid: every (block, 64-row tile) of every "
                   "chunked bucket); chunked_block_apply is its "
                   "one-descriptor call",
         "max_abs_err": errs2["B1"], "max_abs_err_phase1": errs1["B1"],
         "max_abs_err_multi": max(errs1["B1 multi"], errs5["B1 multi"]),
         "max_abs_err_duality": errs1["B1 duality"],
         "ms": times["SpMV bucket"][0], "plain_ms": times["SpMV bucket"][1],
         "graph_ms": times["SpMV bucket"][2],
         "plain_graph_ms": times["SpMV bucket"][3],
         "timed": "bucket route of A @ x, n=8192, 2000 x 128x128 f32",
         "card": card, "launches_symmetric": launches5["B1 sym"],
         "max_abs_err_symmetric": errs4["B1"],
         "sym_ms": sym_times["SpMV bucket"][0],
         "sym_plain_ms": sym_times["SpMV bucket"][1],
         "sym_graph_ms": sym_times["SpMV bucket"][2],
         "sym_plain_graph_ms": sym_times["SpMV bucket"][3],
         "sym_timed": "bucket route of S @ x, n=32768, 384 + 4096 f32 blocks "
                      "(symmetric)",
         "sym_bound_ms": sym_times["bound"]["SpMV bucket"][0],
         "sym_pass_graph_ms": split["B1 pass"],
         "sym_pass_bound_ms": sym_times["B1 pass bound"][0],
         "sym_pass_per_bucket_graph_ms": split["B1 pass per bucket"],
         "sym_pass_timed": "the off-diagonal B1 symmetric pass alone, one "
                           "launch; per_bucket: one launch per bucket",
         "vbcrs_ms": v_times["SpMV bucket"][0],
         "vbcrs_graph_ms": v_times["SpMV bucket"][2],
         "vbcrs_timed": "bucket route of V @ x, config 3, n=32768",
         **measured(times["bound"]["SpMV"], times["library"]["SpMV"]),
         "dtypes": ALL_DTYPES,
         "max_abs_err_complex_phase1": errs1["B1 complex"],
         "max_abs_err_complex_multi": errs1["B1 multi complex"],
         "max_abs_err_complex_duality": errs1["B1 duality complex"],
         "max_abs_err_complex": max(v for k_, v in cx["errs"].items()
                                    if not k_.startswith(("split",
                                                          "scattered"))),
         **cx_times,
         "distributed_ms": {k: r["times"]["ms"]
                            for k, r in dist["operands"].items()
                            if "times" in r},
         "distributed_graph_ms": {k: r["times"]["graph_ms"]
                                  for k, r in dist["operands"].items()
                                  if "times" in r},
         "complex_timed": "S @ x (r = 1), S @ X (r = 16, _r16; r = 64, "
                          "_r64), the complex64 Helmholtz BEM at n=8192 "
                          "(phase 13): 2 B1 launches (r > 1: the tensor-core "
                          "instance; fma: the FMA instance on the same "
                          "tables); split: split_complex(S), four f32 "
                          "products"},
        {"name": "fused_spmm complex64 tensor cores (B1)", "route": "cuda",
         "source": B1_MMA_SRC, "replaces": B1_REPLACES,
         "entry_points": ["bst_fused_spmm_mma_c64"],
         "launches": cx["launches"]["mma"],
         "launches_by_path": {
             "complex Helmholtz BEM S @ X at r = 64 and 16 (phase 13)":
                 cx["launches"]["mma"]},
         "design": "the real embedding: view_as_real(V) [M, 2K] @ B [2K, "
                   "2r], B's rows (Xr, Xi) and (-Xi, Xr) formed from the "
                   "staged x row at fragment load; mma.sync m16n8k8 3xTF32, "
                   "a three-deep cp.async ring of 16 complex rows, float2 "
                   "atomics; the symmetric mode reads V twice",
         "max_abs_err": cx["errs"]["S @ X"],
         "max_abs_err_r16": cx["errs"]["S @ X r=16"],
         "max_abs_err_phase1": errs1["B1 mma"],
         "max_abs_err_vs_fma_phase1": errs1["B1 mma vs fma"],
         "ms": mma_t["ms"], "graph_ms": mma_t["graph_ms"],
         "plain_ms": mma_t["plain_ms"],
         "plain_graph_ms": mma_t["plain_graph_ms"],
         "bound_ms": mma_t["bound_ms"], "bound_by": mma_t["bound_by"],
         "library_ms": mma_t["library_ms"],
         "library_graph_ms": mma_t["library_graph_ms"],
         "fma_ms": mma_t["fma_ms"], "fma_graph_ms": mma_t["fma_graph_ms"],
         "split_ms": mma_t["split_ms"],
         "split_graph_ms": mma_t["split_graph_ms"],
         **{f"r16_{k}": mma16[k] for k in (
             "ms", "graph_ms", "plain_ms", "bound_ms", "library_ms",
             "library_graph_ms", "fma_ms", "fma_graph_ms", "split_ms",
             "split_graph_ms")},
         "instance_scan_graph_ms": cx["times"]["instance scan"]["scan"],
         "scan_takes_from_r": cx["times"]["instance scan"]["takes"],
         "mma_min_r": cx["times"]["instance scan"]["min_r"],
         "timed": "S @ X, r = 64, the complex64 Helmholtz BEM at n=8192 "
                  "(phase 13), both launches; library: a complex64 CSR "
                  "@ X (torch.sparse); fma / split: the FMA instance on the "
                  "same tables / split_complex(S)",
         "card": card, "dtypes": ["complex64"]},
        {"name": "patch_spmm forward (B2)", "route": "cuda", "source": B2_SRC,
         "replaces": B2_REPLACES, "launches": launches["B2 forward"],
         "launches_main_path": launches["B2"],
         "design": "wgmma + TMA on X^T: 64-row blocks (one consumer "
                   "warpgroup, one producer warp, two blocks per SM; no "
                   "clusters), "
                   "tier 1 ('highest'/'high') 3xTF32 with register-A "
                   "splits and per-stage sums, tier 0 (None) one TF32 pass "
                   "from shared memory",
         "max_abs_err": errs2["B2"], "max_abs_err_phase1": errs1["B2"],
         "max_abs_err_tf32_phase1": errs1["B2 tf32"],
         "max_abs_err_duality": errs1["B2 duality"],
         "max_abs_err_none": b2["none_err"],
         "ms": times["SpMM r=128"][0], "plain_ms": times["SpMM r=128"][1],
         "graph_ms": times["SpMM r=128"][2],
         "plain_graph_ms": times["SpMM r=128"][3],
         "timed": "A @ X, n=8192, 2000 x 128x128 f32, r=128, "
                  "precision='highest' (3xTF32), prologue included; none: "
                  "an operator built with precision=None (TF32)",
         "card": card,
         **measured(times["bound"]["SpMM r=128"],
                    times["library"]["SpMM r=128"]),
         "none_ms": b2[("A @ X", None)][0],
         "none_graph_ms": b2[("A @ X", None)][1],
         "none_bound_ms": times["bound"]["SpMM r=128 None"][0],
         "none_bound_by": times["bound"]["SpMM r=128 None"][1],
         "host_us_per_call": b2["host_us"],
         **{f"{key}{'_none' if prec is None else ''}_{k}": b2[(part, prec)][i]
            for part, key in (("forward", "bucket"), ("B4 P=1", "b4_p1"))
            for prec in ("highest", None)
            for i, k in enumerate(("ms", "graph_ms"))}},
        {"name": "patch_spmm transpose (B2's transpose: wgmma + TMA, V^T "
                 "in registers)", "route": "cuda", "source": B2_TR_SRC,
         "replaces": B2_TR_REPLACES, "launches": launches["B2 transpose"],
         "launches_by_path": {
             "flagship main path A.H @ X (phase 2)": launches["B2 transpose"],
             "batched_mm dX, config 4 and config 3 (phase 9)":
                 batch["launches"]["B2 transpose"]},
         "design": "A = V^T read into registers from TMA boxes of live "
                   "chunks, B = the slot's window of X^T kept in shared "
                   "memory for every 64-row tile of the block; one producer "
                   "warp per consumer warpgroup, two warpgroups on "
                   "alternate tiles; tiles added into Y by TMA reduce-add "
                   "from swizzled staging; product axis in grid z "
                   "(batched_mm's dX)",
         "max_abs_err": b2["transpose_err"],
         "max_abs_err_none": b2["transpose_none_err"],
         "max_abs_err_phase1": errs1["B2 transpose"],
         "max_abs_err_tf32_phase1": errs1["B2 transpose tf32"],
         "max_abs_err_duality": errs1["B2 transpose duality"],
         "max_abs_err_flagship": errs2["B2 transpose"],
         "max_abs_err_dx": batch["dX"]["errs"]["highest"],
         "max_abs_err_dx_none": batch["dX"]["errs"][None],
         "ms": b2[("A.T @ X", "highest")][0],
         "graph_ms": b2[("A.T @ X", "highest")][1],
         "plain_ms": times["SpMM r=128 transpose plain"][0],
         "plain_graph_ms": times["SpMM r=128 transpose plain"][1],
         "none_ms": b2[("A.T @ X", None)][0],
         "none_graph_ms": b2[("A.T @ X", None)][1],
         "none_bound_ms": times["bound"]["SpMM r=128 None"][0],
         "none_bound_by": times["bound"]["SpMM r=128 None"][1],
         **{f"kernel{'_none' if prec is None else ''}_{k}":
            b2[("transposed kernel", prec)][i]
            for prec in ("highest", None)
            for i, k in enumerate(("ms", "graph_ms"))},
         **{f"dx{'_none' if key == 'none' else ''}_{k}": batch["dX"][key][i]
            for key in ("highest", "none")
            for i, k in enumerate(("ms", "graph_ms"))},
         "dx_plain_ms": batch["dX"]["plain"][0],
         "dx_plain_graph_ms": batch["dX"]["plain"][1],
         "dx_bound_ms": batch["dX"]["bound"][0],
         "dx_none_bound_ms": batch["dX"]["bound none"][0],
         "dx_library_ms": batch["dX"]["library"],
         "dx_library_graph_ms": batch["dX"]["library"].graph,
         "timed": "A.T @ X, n=8192, 2000 x 128x128 f32, r=128, "
                  "precision='highest', prologue included; none: "
                  "precision=None; kernel: the transposed launch alone; dx: "
                  "batched_mm's dX, P=4 x that operand",
         "card": card,
         **measured(times["bound"]["SpMM r=128"],
                    times["library"]["SpMM r=128 transpose"])},
        {"name": "patch_spmm prologue (B2's X^T)", "route": "cuda",
         "source": B2_SRC, "replaces": B2_REPLACES,
         "launches": launches["B2 prologue"],
         "max_abs_err": errs1["B2 prologue"],
         "ms": b2[("prologue", "highest")][0],
         "graph_ms": b2[("prologue", "highest")][1],
         "plain_ms": times["prologue plain"][0],
         "plain_graph_ms": times["prologue plain"][1],
         "none_ms": b2[("prologue", None)][0],
         "none_graph_ms": b2[("prologue", None)][1],
         "none_bound_ms": times["bound"]["prologue None"][0],
         "timed": "X [8192, 128] -> hi, lo [128, 8192] (tier 1); none: hi "
                  "only (tier 0); one launch per forward or transposed "
                  "product", "card": card,
         **measured(times["bound"]["prologue"], None)},
        {"name": "patch_sym (B3)", "route": "cuda", "source": B3_SRC,
         "replaces": B3_REPLACES, "launches": launches4["B3"],
         "max_abs_err": errs4["B3"], "max_abs_err_phase1": errs1["B3"],
         "max_abs_err_tf32_phase1": errs1["B3 tf32"],
         "max_abs_err_none": b3["none_err"],
         "max_abs_err_adjoint": b3["adjoint_err"],
         "ms": sym_times["SpMM r=128"][0],
         "plain_ms": sym_times["SpMM r=128"][1],
         "graph_ms": sym_times["SpMM r=128"][2],
         "plain_graph_ms": sym_times["SpMM r=128"][3],
         "timed": "S @ X, n=32768, 384 + 4096 f32 blocks (symmetric), r=128, "
                  "precision='highest' (3xTF32); none: precision=None (TF32)",
         "card": card, **measured(sym_times["bound"]["SpMM r=128"],
                                  sym_times["library"]["SpMM r=128"]),
         "none_ms": b3["none"][0], "none_graph_ms": b3["none"][1],
         "none_bound_ms": sym_times["bound"]["SpMM r=128 None"][0],
         "none_bound_by": sym_times["bound"]["SpMM r=128 None"][1],
         "adjoint_ms": b3["adjoint"][0], "adjoint_graph_ms": b3["adjoint"][1],
         "forward_blocks_graph_ms": b3["forward blocks highest"],
         "none_forward_blocks_graph_ms": b3["forward blocks None"]},
    ] + [
        {"name": "mask_select element pass (B9)", "route": "cuda",
         "source": B9_SRC, "replaces": B9_GATHER_REPLACES,
         "replaces_also": B9_SCATTER_REPLACES,
         "launches": launches5["B9 element"],
         "launches_by_path": element_launches,
         "design": "the element buckets' gather -> product -> scatter-add "
                   "in one launch per layout on B1's tile core with element "
                   "row maps",
         "max_abs_err": errs5["bucket route"],
         "max_abs_err_kernel": errs5["B9 element"],
         "max_abs_err_phase1": errs1["B9 element"],
         "max_abs_err_duality": errs1["B9 element duality"],
         "ms": sym_times["element pass"][0],
         "plain_ms": sym_times["element pass"][1],
         "graph_ms": sym_times["element pass"][2],
         "plain_graph_ms": sym_times["element pass"][3],
         "per_bucket_graph_ms": split["element pass per bucket (B9)"],
         "per_bucket_torch_graph_ms":
             split["element pass per bucket (torch ops)"],
         "timed": "the element off-diagonal pass of S @ x, n=32768 "
                  "(symmetric), one launch; per_bucket: the chain of "
                  "one-call gathers and scatter-adds",
         "card": card, **measured(sym_times["element bound"],
                                  sym_times["element library"]),
         "dtypes": ALL_DTYPES,
         "max_abs_err_complex_phase1": errs1["B9 element complex"],
         "max_abs_err_complex": max(v for k_, v in cx["errs"].items()
                                    if k_.startswith("scattered"))},
    ] + [
        {"name": "mask_select colored rounds (B9)", "route": "cuda",
         "source": B9_ROUNDS_SRC, "replaces": B9_GATHER_REPLACES,
         "replaces_also": [B9_SCATTER_REPLACES, B9_COLORED_REPLACES],
         "launches": scattered["colored"]["B9 rounds"],
         "launches_by_path": {
             "scattered symmetric main path S @ x, colored (phase 4)":
                 scattered["colored"]["B9 rounds"],
             "the same with its backward and the bucket-route S @ X r=64 "
             "(phase 4)": scattered["colored with backward"]["B9 rounds"]},
         "launches_products": scattered["colored"]["B9 colored"],
         "design": "the colored element route: a products pass writes "
                   "every (block, row) product into a scratch in the plan's "
                   "flat order (at r = 1 one launch of the "
                   "one-read products kernel, both symmetric parts from one "
                   "read of V; at r > 1 the tile core, two launches on the "
                   "symmetric pass), then one launch sums every color round "
                   "per output row in color order in registers (int32 "
                   "[colors, out_len] tables, one thread per (row, column)), "
                   "one write per entry, no atomics",
         "max_abs_err": scattered["times"][1]["err"],
         "max_abs_err_r64": scattered["times"][64]["err"],
         "max_abs_err_phase1": errs1["B9 rounds"],
         "max_abs_err_route_phase1": errs1["B9 colored"],
         "max_abs_err_one_read_phase1": errs1["B9 colored one-read"],
         "max_abs_err_real": colored_real["times"][1]["err"],
         "ms": colored_real["rounds"]["ms"],
         "graph_ms": colored_real["rounds"]["graph_ms"],
         "plain_ms": colored_real["rounds"]["plain_ms"],
         "plain_graph_ms": colored_real["rounds"]["plain_graph_ms"],
         **measured(colored_real["rounds"]["bound"],
                    colored_real["rounds"]["library"]),
         "timed": "the rounds launch alone on the off-diagonal pass of the "
                  "real-size colored cell (n=32768, scattered groups, "
                  f"{colored_real['rounds']['colors']} colors), r = 1; "
                  "library: its gather matrix in CSR times the scratch "
                  "(torch.sparse); cells: the whole colored route beside "
                  "the serial route, the old chain and the expanded CSR, "
                  "graph ms",
         "cells": {
             f"{cell} r={r}": {k: (v if not isinstance(v, tuple) else v[0])
                               for k, v in t_.items()
                               if k.endswith(("graph", "eager", "bound"))}
             | {"library_ms": float(t_["library"]),
                "library_graph_ms": t_["library"].graph}
             for cell, tt in (("scattered flagship", scattered["times"]),
                              ("real size", colored_real["times"]))
             for r, t_ in tt.items()},
         "card": card},
        {"name": "mask_select colored products, one read (B9, r = 1)",
         "route": "cuda", "source": B9_ROUNDS_SRC,
         "replaces": B9_GATHER_REPLACES,
         "replaces_also": [B9_COLORED_REPLACES],
         "launches": sum(v for k, v in scattered["colored entries"].items()
                         if k.startswith("bst_colored_products_r1")),
         "launches_by_path": {
             "scattered symmetric main path S @ x, colored (phase 4)":
                 sum(v for k, v in scattered["colored entries"].items()
                     if k.startswith("bst_colored_products_r1"))},
         "entry_points": ["bst_colored_products_r1_<pair>"],
         "design": "a thread block per (stored block, 64-row tile), each "
                   "value read once in stored row order; forward rows "
                   "summed by warp shuffles, mirror columns by lane "
                   "partials then the 8 warps in order, and for blocks of "
                   "several tiles by the block's last tile from the tile "
                   "partials in tile order; both parts of the symmetric "
                   "pass from one read; every scratch row one writer",
         "max_abs_err": colored_real["products"]["err"],
         "max_abs_err_phase1": errs1["B9 colored one-read"],
         "ms": colored_real["products"]["one-read ms"],
         "graph_ms": colored_real["products"]["one-read graph"],
         "plain_ms": colored_real["products"]["plain ms"],
         "plain_graph_ms": colored_real["products"]["plain graph"],
         "tile_ms": colored_real["products"]["tile ms"],
         "tile_graph_ms": colored_real["products"]["tile graph"],
         **measured(colored_real["products"]["bound"],
                    colored_real["products"]["library"]),
         "flagship_graph_ms": scattered["products"]["one-read graph"],
         "flagship_tile_graph_ms": scattered["products"]["tile graph"],
         "timed": "the symmetric pass's products alone at r = 1 on the "
                  "real-size colored cell (n=32768, scattered groups); "
                  "tile: the owner mode's products pass, two launches, on "
                  "the same tables; library: the pass's products as one "
                  "matrix in CSR times x (torch.sparse)",
         "card": card,
         "dtypes": [pair_name(s_, c_) for s_, c_ in VALUE_PAIRS]},
    ] + [
        {"name": f"mask_select {kind} (B9, one call)", "route": "cuda",
         "source": B9_SRC, "replaces": rep_,
         "launches": single[kind]["launches"] + single[kind + " 1M"][
             "launches"],
         "launches_by_path": {
             "called directly on phase 5's index tables (no product route "
             "runs it: the colored route runs the rounds)":
                 single[kind]["launches"] + single[kind + " 1M"]["launches"]},
         "max_abs_err": errs5[f"B9 {kind}"],
         "max_abs_err_phase1": errs1[f"B9 {kind}"],
         "ms": single[kind]["ms"], "graph_ms": single[kind]["graph_ms"],
         "plain_ms": single[kind]["plain_ms"],
         "timed": f"one call on the largest index table of the symmetric "
                  f"real size's element buckets ({single[kind]['indices']} "
                  f"indices, n=32768); _1m: on {single[kind + ' 1M']['indices']}"
                  f" random indices",
         "card": card,
         **measured(single[kind]["bound"], single[kind]["library_ms"]),
         **{f"{k}_1m": single[kind + " 1M"][k]
            for k in ("ms", "graph_ms", "plain_ms")},
         "bound_ms_1m": single[kind + " 1M"]["bound"][0],
         "library_ms_1m": single[kind + " 1M"]["library_ms"],
         "library_graph_ms_1m": single[kind + " 1M"]["library_ms"].graph}
        for kind, rep_ in (("gather", B9_GATHER_REPLACES),
                           ("scatter", B9_SCATTER_REPLACES))
    ] + [
        {"name": "panel_spmv (B5)", "route": "cuda", "source": B5_SRC,
         "replaces": B5_REPLACES, "launches": sum(b5_launches.values()),
         "launches_by_path": b5_launches,
         "launches_mirror": launches4["B5 mirror"],
         "max_abs_err": max(errs6["B5"], errs7["B5"]),
         "max_abs_err_phase1": errs1["B5"],
         "max_abs_err_duality": max(errs1["B5 duality"], errs6["B5 duality"],
                                    errs7["B5 duality"]),
         "ms": v_times["SpMV"][0], "plain_ms": v_times["SpMV"][1],
         "graph_ms": v_times["SpMV"][2], "plain_graph_ms": v_times["SpMV"][3],
         "timed": "V @ x, config-3 VBCRS n=32768 (panel plan)", "card": card,
         "bsm_ms": times["SpMV"][0], "bsm_plain_ms": times["SpMV"][1],
         "bsm_graph_ms": times["SpMV"][2],
         "bsm_plain_graph_ms": times["SpMV"][3],
         "sym_ms": sym_times["SpMV"][0], "sym_plain_ms": sym_times["SpMV"][1],
         "sym_graph_ms": sym_times["SpMV"][2],
         "sym_plain_graph_ms": sym_times["SpMV"][3],
         "sym_bound_ms": sym_times["bound"]["SpMV"][0],
         "sym_library_ms": sym_times["library"]["SpMV"],
         "sym_library_graph_ms": getattr(sym_times["library"]["SpMV"],
                                         "graph", None),
         "sym_plan": describe(sym_times["op"]._stream_entry(False)[1]),
         "sym_rule": {k: sym_times["rule"][k] for k in (
             "measured_factor", "h100_pick", "jax_pick")}
         | {"fused_graph_ms": sym_times["rule"]["fused"]["graph_ms"],
            "expanded_graph_ms": sym_times["rule"]["expanded"]["graph_ms"]},
         "grad_ms": {"symmetric": sym_times["grad"], "VBCRS": v_times["grad"]},
         "mirror_ms": launches4["times"]["SpMV"][0],
         "mirror_plain_ms": launches4["times"]["SpMV"][1],
         "mirror_graph_ms": launches4["times"]["SpMV"][2],
         "mirror_plain_graph_ms": launches4["times"]["SpMV"][3],
         "mirror_timed": "S @ x, symmetric flagship (fused mirror plan)",
         **measured(v_times["bound"]["SpMV"], v_times["library"]["SpMV"])},
        {"name": "slab_spmv (B8)", "route": "cuda", "source": B8_SRC,
         "replaces": B8_REPLACES, "launches": slab_times["launches"],
         "max_abs_err": max(errs7["B8"], errs8["B8"]),
         "max_abs_err_phase1": errs1["B8"],
         "max_abs_err_duality": max(errs1["B8 duality"], errs7["B8 duality"],
                                    errs8["B8 duality"]),
         "ms": slab_times["SpMV"][0], "plain_ms": slab_times["SpMV"][1],
         "graph_ms": slab_times["SpMV"][2],
         "plain_graph_ms": slab_times["SpMV"][3],
         "timed": "A @ x, n=8192 strided-row BSM (slab plan)", "card": card,
         "vbcrs_ms": v_times["B8"][0], "vbcrs_plain_ms": v_times["B8"][1],
         "vbcrs_graph_ms": v_times["B8"][2],
         "vbcrs_plain_graph_ms": v_times["B8"][3],
         "vbcrs_timed": "config-3 VBCRS n=32768 slab plan",
         **measured(slab_times["bound"]["SpMV"],
                    slab_times["library"]["SpMV"])},
        {"name": "batched_spmm (B4)", "route": "cuda", "source": B4_SRC,
         "replaces": B4_REPLACES, "launches": sum(b4_launches.values()),
         "launches_by_path": b4_launches,
         "max_abs_err": batch["errs"]["B4"], "max_abs_err_phase1": errs1["B4"],
         "max_abs_err_duality": errs1["B4 duality"],
         "max_abs_err_tf32_phase1": errs1["B4 tf32"],
         "max_abs_err_none": batch["errs"]["B4 tf32"],
         "ms": mm["B4"][0], "plain_ms": mm["plain"][0],
         "graph_ms": mm["B4"][1], "plain_graph_ms": mm["plain"][1],
         "loop_ms": mm["loop"][0], "loop_graph_ms": mm["loop"][1],
         "timed": "batched_mm, P=4 x (n=8192, 2000 x 128x128 f32), r=128, "
                  "precision='highest' (3xTF32; loop: 4 B2 launches); none: "
                  "the B4 wrapper at precision=None (TF32)",
         "card": card, **measured(mm["bound"], mm["library"]),
         "none_ms": mm["B4 none"][0], "none_graph_ms": mm["B4 none"][1],
         "none_bound_ms": mm["bound none"][0],
         "none_bound_by": mm["bound none"][1]},
        {"name": "panel_spmv_batched (B6)", "route": "cuda", "source": B5_SRC,
         "replaces": B6_REPLACES, "launches": sum(b6_launches.values()),
         "launches_by_path": b6_launches,
         "launches_mirror": batch["launches"]["B6 mirror config 2"],
         "max_abs_err": batch["errs"]["B6"], "max_abs_err_phase1": errs1["B6"],
         "max_abs_err_duality": errs1["B6 duality"],
         "ms": mv3["B6"][0], "plain_ms": mv3["plain"][0],
         "graph_ms": mv3["B6"][1], "plain_graph_ms": mv3["plain"][1],
         "loop_ms": mv3["loop"][0], "loop_graph_ms": mv3["loop"][1],
         "timed": "batched_mv, P=16 x config-3 VBCRS n=4096 (loop: 16 B5 "
                  "launches)",
         "card": card, **measured(mv3["bound"], mv3["library"]),
         "mirror_ms": mv2["B6"][0], "mirror_plain_ms": mv2["plain"][0],
         "mirror_graph_ms": mv2["B6"][1], "mirror_plain_graph_ms": mv2["plain"][1],
         "mirror_loop_ms": mv2["loop"][0], "mirror_loop_graph_ms": mv2["loop"][1],
         "mirror_bound_ms": mv2["bound"][0], "mirror_library_ms": mv2["library"],
         "mirror_library_graph_ms": mv2["library"].graph,
         "mirror_timed": "batched_mv, P=16 x config-2 symmetric n=4096 (fused "
                         "mirror plan)",
         "capped_ms": capped["B6"][0], "capped_graph_ms": capped["B6"][1],
         "capped_loop_ms": capped["loop"][0],
         "capped_loop_graph_ms": capped["loop"][1],
         "capped_bound_ms": capped["bound"][0],
         "capped_timed": "B6 driven on the stacked plan, P=4 x config-3 VBCRS "
                         "n=32768, above the 24 MB cap (the batch loops)"},
        {"name": "patch_spmv1 (B7)", "route": "cuda", "source": B7_SRC,
         "replaces": B7_REPLACES, "launches": sum(b7["launches"].values()),
         "launches_by_path": b7["launches"],
         "max_abs_err": b7["errs"]["B7"],
         "max_abs_err_float64": b7["errs"]["B7 float64"],
         "max_abs_err_phase1": errs1["B7"],
         "max_abs_err_duality": max(errs1["B7 duality"],
                                    b7["errs"]["B7 duality"]),
         **{k: b7["times"]["vbcrs"][k] for k in
            ("ms", "plain_ms", "graph_ms", "plain_graph_ms")},
         "timed": "V @ x, config-3 VBCRS n=32768, patch='always' (b5: the "
                  "default operator beside it)", "card": card,
         **measured(b7["times"]["vbcrs"]["bound"], b7["library"]["vbcrs"]),
         **per_operand(b7),
         **{f"{k}_library_ms": v for k, v in b7["library"].items()},
         **{f"{k}_library_graph_ms": v.graph for k, v in b7["library"].items()}},
        {"name": "panel2_spmv (B10)", "route": "cuda", "source": B10_SRC,
         "replaces": B10_REPLACES, "launches": sum(b10["launches"].values()),
         "launches_by_path": b10["launches"],
         "launches_mirror": sum(b10["mirror"].values()),
         "max_abs_err": b10["errs"]["B10"],
         "max_abs_err_float64": b10["errs"]["B10 float64"],
         "max_abs_err_phase1": errs1["B10"],
         "max_abs_err_duality": max(errs1["B10 duality"],
                                    b10["errs"]["B10 duality"]),
         **{k: b10["times"]["vbcrs"][k] for k in
            ("ms", "plain_ms", "graph_ms", "plain_graph_ms")},
         "timed": "V @ x, config-3 VBCRS n=32768, panel='v2' (b5: the "
                  "default operator beside it)", "card": card,
         **measured(b10["times"]["vbcrs"]["bound"],
                    b10["times"]["vbcrs"]["library_ms"]),
         **per_operand(b10),
         **{f"{k}_library_ms": t["library_ms"]
            for k, t in b10["times"].items()}},
    ]}
    c1 = cx["c128"]
    t128 = c1["times"]["S @ X"]
    summary["kernels"].append(
        {"name": "fused_spmm complex128 tensor cores (B1)", "route": "cuda",
         "source": B1_DMMA_SRC, "replaces": B1_REPLACES,
         "entry_points": [fused_spmm.MMA_RULES[(torch.complex128,
                                                torch.complex128)].entry],
         "launches": c1["launches"],
         "launches_by_path": {
             "complex128 Helmholtz BEM S @ X at r = 64 and 16 (phase 13)":
                 c1["launches"]},
         "design": "the real embedding of the complex64 instance on f64 "
                   "mma.sync m16n8k8 (IEEE f64: no split, no depth cap); "
                   "eight warps (2 x 4) of 32 rows x 8 WN real columns, "
                   "the b1_mma.cuh ring of 8 complex rows (16 below WN = "
                   "4), 16-byte copies, two double atomics per complex "
                   "value",
         "max_abs_err": c1["errs"]["S @ X"],
         "max_abs_err_r16": c1["errs"]["S @ X r=16"],
         "max_abs_err_phase1": errs1["B1 mma c128"],
         "max_abs_err_vs_fma_phase1": errs1["B1 mma c128 vs fma"],
         "ms": t128["ms"], "graph_ms": t128["graph_ms"],
         "plain_ms": t128["plain_ms"],
         "plain_graph_ms": t128["plain_graph_ms"],
         "bound_ms": t128["bound"][0], "bound_by": t128["bound"][1],
         "library_ms": t128["library_ms"],
         "library_graph_ms": t128["library_graph_ms"],
         "fma_ms": t128["fma_ms"], "fma_graph_ms": t128["fma_graph_ms"],
         **{f"r16_{k}": c1["times"]["S @ X r=16"][k] for k in (
             "ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
             "fma_ms", "fma_graph_ms")},
         "r16_bound_ms": c1["times"]["S @ X r=16"]["bound"][0],
         "instance_scan_graph_ms": c1["scan"]["scan"],
         "scan_takes_from_r": c1["scan"]["takes"],
         "mma_min_r": c1["scan"]["min_r"],
         "timed": "S @ X, r = 64, the complex128 Helmholtz BEM at n=8192 "
                  "(phase 13), both launches; library: a complex128 CSR @ X "
                  "(torch.sparse); fma: the FMA instance on the same tables",
         "card": card, "dtypes": ["complex128"]})
    # the row-stream body (r = 1): its launches on the main paths, its
    # timed product beside the tile core's on the same tables, and every
    # r = 1 comparison of the run
    r1_rows = {"config 1 A @ x (phase 3)": times["r1 bodies"],
               "symmetric real size S @ x (phase 5)": sym_times["r1 bodies"],
               "symmetric real size, B1 symmetric pass alone (phase 5)":
                   sym_times["r1 pass"],
               "VBCRS real size A @ x (phase 7)": v_times["r1 bodies"],
               "BEM solve M @ p (phase 12)": solve["r1 bodies"],
               "complex64 BEM S @ x (phase 13)": cx["times"]["S @ x"]["r1"],
               "complex128 BEM S @ x (phase 13)":
                   cx["c128"]["times"]["S @ x"]["r1"],
               **{f"{k} (phase 14)": t_["r1"]
                  for k, t_ in opts["times"].items()
                  if isinstance(t_, dict) and "r1" in t_}}
    rows_b1 = {"flagship main path (phase 2)": launches["B1 rows"],
               "complex Helmholtz BEM products (phase 13)":
                   cx["launches"]["rows"]}
    rows_b9 = {"scattered complex Helmholtz BEM products, serial (phase 13)":
               cx["launches"]["element rows"]}
    require(sum(rows_b1.values()) and sum(rows_b9.values()),
            f"a main path skipped the row-stream body: {rows_b1}, {rows_b9}")
    cx1, r1c = cx["times"]["S @ x"], cx["times"]["S @ x"]["r1"]
    b9t, b9s = opts["times"]["B9 element f32 BEM"], opts["r1 scan"]["B9 f32"]
    summary["kernels"] += [
        {"name": "fused_spmm row-stream body (B1, r = 1)", "route": "cuda",
         "source": ROWS_SRC, "replaces": B1_REPLACES,
         "launches": sum(rows_b1.values()), "launches_by_path": rows_b1,
         "max_abs_err": errs1["rows B1"],
         "max_abs_err_vs_tile": errs1["rows vs tile"],
         "ms": r1c["rows_ms"], "graph_ms": r1c["rows_graph_ms"],
         "plain_ms": cx1["plain_ms"], "plain_graph_ms": cx1["plain_graph_ms"],
         "bound_ms": cx1["bound_ms"], "bound_by": cx1["bound_by"],
         "library_ms": cx1["library_ms"],
         "library_graph_ms": cx1["library_graph_ms"],
         "tile_ms": r1c["tile_ms"], "tile_graph_ms": r1c["tile_graph_ms"],
         "rules": {pair_name(s_, c_): b_._asdict()
                   for (s_, c_), b_ in fused_spmm.R1_RULES.items()},
         "rule_scan": opts["r1 scan"],
         "r1_comparisons": r1_rows,
         "entry_points": ["bst_fused_spmm_rows_<pair>"],
         "timed": "S @ x, the complex64 Helmholtz BEM at n=8192 (phase 13), "
                  "both launches driven directly on its tables; tile: the "
                  "tile core on the same tables; library: a complex64 CSR "
                  "call (torch.sparse)",
         "card": card,
         "dtypes": [pair_name(s_, c_) for s_, c_ in VALUE_PAIRS]},
        {"name": "mask_select element pass row-stream body (B9, r = 1)",
         "route": "cuda", "source": ROWS_SRC, "replaces": B9_SCATTER_REPLACES,
         "replaces_also": B9_GATHER_REPLACES,
         "launches": sum(rows_b9.values()), "launches_by_path": rows_b9,
         "max_abs_err": errs1["rows B9"],
         "ms": b9s["rows_ms"], "graph_ms": b9s["rows_graph_ms"],
         "plain_ms": b9t["plain_ms"], "plain_graph_ms": b9t["plain_graph_ms"],
         "bound_ms": b9t["bound"][0], "bound_by": b9t["bound"][1],
         "library_ms": opts["rows library"],
         "library_graph_ms": opts["rows library"].graph,
         "tile_ms": b9s["tile_ms"], "tile_graph_ms": b9s["tile_graph_ms"],
         "entry_points": ["bst_element_pass_rows_<pair>"],
         "timed": "S @ x, phase 12's BEM n=8192 on scattered index lists "
                  "(serial), f32, both launches driven directly on its "
                  "tables (phase 14's rule scan); tile: the tile core on "
                  "the same tables; library: a float32 CSR call (cuSPARSE)",
         "card": card,
         "dtypes": [pair_name(s_, c_) for s_, c_ in VALUE_PAIRS]}]
    phase1_keys = {"fused_spmm bf16->f32 tensor cores (B1)":
                   "B1 mma bf16->f32",
                   "fused_spmm float64 tensor cores (B1)": "B1 mma f64"}
    for entry in opts["kernels"]:
        if entry["name"] in phase1_keys:
            key = phase1_keys[entry["name"]]
            entry.update(max_abs_err_phase1=errs1[key],
                         max_abs_err_vs_fma_phase1=errs1[f"{key} vs fma"])
            if key == "B1 mma bf16->f32":  # and complex64's, beside it
                entry["depth_err_of_max_y"] = errs1["mma depth"]
    summary["kernels"] += opts["kernels"]
    require(all(k["launches"] for k in opts["kernels"]),
            f"phase 14 skipped an instance: "
            f"{ {k['name']: k['launches'] for k in opts['kernels']} }")
    for entry in summary["kernels"]:
        entry.setdefault("dtypes", ["float32"])
        kernel = re.search(r"\((B\d+)[) ]", entry["name"])
        if kernel and tuned["launches"].get(kernel.group(1)):
            # the tuned and the loaded products of phase 16
            entry["launches_autotune"] = tuned["launches"][kernel.group(1)]
    print_rooflines(summary, card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
