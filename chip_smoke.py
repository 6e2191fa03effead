#!/usr/bin/env python3
"""Smoke run of the PyTorch port (blocksparse_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``blocksparse_tpu_torch/csrc`` and runs:

  1. each kernel against its plain PyTorch version on the card (B1: forward,
     transpose, symmetric x f32/f64 x r in {1, 64, 200}; B2: forward,
     transpose x r in {64, 128, 300});
  2. the flagship operator (4096^2, 200 contiguous 64x64 f32 blocks, r = 64):
     each kernel against its plain version at the flagship's shapes, then
     the main path once with the launch counters reset -- A @ X, A @ x,
     A.T @ x, A.H @ X, A.axpby(x, y, 2.0, 0.5), (A @ A) @ x -- each checked
     against a float64 scipy oracle, and the gradients of A @ X and A @ x
     (backward passes through the kernels) against A^T w;
  3. the real size (n = 8192, 2000 contiguous 128x128 f32 blocks, 131 MB of
     values): SpMV and SpMM at r = 128 against the float64 plain version,
     median CUDA-event times of the kernel route and the plain route, eager
     and replayed from a CUDA graph (the latter without host launch
     overhead).

Tolerances: |kernel - reference| <= tol * max(1, max|reference|) with tol
1e-5 for f32 and 1e-12 for f64; the kernels add into their outputs with
atomics (run-to-run summation order) and FMA, so bit equality is not
expected.  Any failure raises and exits nonzero.  The second-to-last line
is a JSON summary of the kernels, the last line a JSON device record.

Needs one CUDA card, nvcc, torch and scipy; imports no jax.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")

import blocksparse_tpu_torch as bt  # noqa: E402
from blocksparse_tpu_torch.core.layout import build_layout  # noqa: E402
from blocksparse_tpu_torch.ops import patch_engine  # noqa: E402
from blocksparse_tpu_torch.ops.dispatch import patch_wins  # noqa: E402
from blocksparse_tpu_torch.ops.kernels import fused_spmm  # noqa: E402
from blocksparse_tpu_torch.ops.torch_spmv import bucket_apply  # noqa: E402
from blocksparse_tpu_torch.utils import build  # noqa: E402
from blocksparse_tpu_torch.utils.testmatrices import random_block_sparse  # noqa: E402

DEV = torch.device("cuda", 0)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
B1_SRC = "blocksparse_tpu_torch/csrc/fused_spmm.cu"
B2_SRC = "blocksparse_tpu_torch/csrc/patch_spmm.cu"
B1_REPLACES = "blocksparse_tpu/ops/pallas/fused_spmm.py:81"
B2_REPLACES = "blocksparse_tpu/ops/patch_engine.py:329"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_check(name: str, got: torch.Tensor, ref, tol: float) -> float:
    """Max |got - ref| against tol * max(1, max|ref|); returns the abs error."""
    ref = torch.as_tensor(np.asarray(ref)) if not isinstance(ref, torch.Tensor) else ref
    got64 = got.detach().double().cpu()
    ref64 = ref.detach().double().cpu()
    require(tuple(got64.shape) == tuple(ref64.shape),
            f"{name}: shape {tuple(got64.shape)} != {tuple(ref64.shape)}")
    require(bool(torch.isfinite(got64).all()), f"{name}: non-finite output")
    err = float((got64 - ref64).abs().max()) if got64.numel() else 0.0
    scale = max(1.0, float(ref64.abs().max()) if ref64.numel() else 1.0)
    print(f"  {name}: max_abs_err {err:.3e}  limit {tol * scale:.3e} "
          f"(tol {tol:g} x {scale:.3g})")
    require(err <= tol * scale, f"{name}: error {err:.3e} above {tol * scale:.3e}")
    return err


def reset_counts() -> None:
    fused_spmm.LAUNCHES = 0
    patch_engine.LAUNCHES = 0


def counts() -> dict:
    return {"B1": fused_spmm.LAUNCHES, "B2": patch_engine.LAUNCHES}


def plain_route(A: bt.BlockSparseMatrix, x: torch.Tensor, *, transpose=False,
                dtype=None) -> torch.Tensor:
    """A's main-path route with every kernel replaced by its plain version,
    optionally in another dtype (the float64 reference on the card)."""
    dtype = dtype or A.dtype
    x = x.to(dtype)
    r = 1 if x.ndim == 1 else x.shape[1]
    if r > 1 and A.dtype == torch.float32:
        entry = A._patch_for()
        if entry is not None and patch_wins(entry[0], [(A.layout, 1)], r):
            plan, dev = entry
            dev = [(v.to(dtype), cc, rs, mk) for v, cc, rs, mk in dev]
            return patch_engine.patch_spmm_plain(plan, dev, x,
                                                 transpose=transpose)
    out_len = A.shape[1] if transpose else A.shape[0]
    y = x.new_zeros((out_len,) + tuple(x.shape[1:]))
    elem = []
    for hb, (v, ri, ci, rc, cc) in zip(A.layout.buckets, A._buckets):
        if hb.chunk > 1:
            y = y + fused_spmm.chunked_block_apply_plain(
                v.to(dtype), rc, cc, hb.chunk, x, out_len, transpose=transpose)
        else:
            elem.append((v.to(dtype), ri, ci))
    if elem:
        y = y + bucket_apply(elem, out_len, x, transpose=transpose)
    return y


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


def graph_ms(fn) -> float:
    """Device time per call without host launch overhead: ``fn`` captured
    once in a CUDA graph, then the median CUDA-event time of its replays.
    The replayed output is checked against an eager call."""
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
    require(float((out - ref).abs().max()) <= TOL[ref.dtype] * scale,
            "CUDA-graph replay disagrees with the eager product")
    return median_ms(graph.replay)


def contiguous_operator(n, nblocks, bs, seed, value_seed, device):
    """nblocks uniform bs x bs f32 blocks at distinct block-aligned positions."""
    rng = np.random.default_rng(seed)
    ntiles = n // bs
    pos = rng.choice(ntiles * ntiles, size=nblocks, replace=False)
    rows = (pos // ntiles) * bs
    cols = (pos % ntiles) * bs
    vrng = rng if value_seed is None else np.random.default_rng(value_seed)
    blocks = [vrng.standard_normal((bs, bs)).astype(np.float32)
              for _ in range(nblocks)]
    A = bt.BlockSparseMatrix(blocks, [np.arange(r, r + bs) for r in rows],
                             [np.arange(c, c + bs) for c in cols], (n, n),
                             device=device)
    return A, vrng


# -- phase 1 -------------------------------------------------------------------

def b1_cases(np_dtype):
    """(label, vals, row_chunk, col_chunk, C, n) on the card."""
    blocks, rows, cols, shape = random_block_sparse(
        3, shape=(1536, 1536), nblocks=120, max_block=96, dtype=np.float64,
        contiguous=True)
    lay = build_layout([b.astype(np_dtype) for b in blocks], rows, cols,
                       shape)
    chunked = [b for b in lay.buckets if b.chunk > 1]
    hb = max(chunked, key=lambda b: b.nblocks * b.mp * b.kp)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    yield (f"contiguous layout bucket nb={hb.nblocks} tile={hb.mp}x{hb.kp} "
           f"C={hb.chunk}", t(hb.values), t(hb.row_chunk_idx),
           t(hb.col_chunk_idx), hb.chunk, shape[0])
    rng = np.random.default_rng(11)
    n, nb, mp, kp, C = 2048, 96, 64, 128, 16
    vals = rng.standard_normal((nb, mp, kp)).astype(np_dtype)
    rc = rng.integers(0, n // C, (nb, mp // C)).astype(np.int32)
    cc = rng.integers(0, n // C, (nb, kp // C)).astype(np.int32)
    yield (f"chunk-scattered tables nb={nb} tile={mp}x{kp} C={C}", t(vals),
           t(rc), t(cc), C, n)


def phase1():
    print("phase 1: kernels against their plain versions")
    errs = {"B1": 0.0, "B2": 0.0}
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
    blocks, rows, cols, shape = random_block_sparse(
        4, shape=(2048, 2048), nblocks=150, max_block=120, dtype=np.float64,
        contiguous=True)
    A = bt.BlockSparseMatrix([b.astype(np.float32) for b in blocks], rows,
                             cols, shape, device=DEV)
    plan, dev = A._patch_for()
    vals, cc, rs, _mk = dev[0]
    print(f"  patch plan: {plan.buckets[0].nb} slots of "
          f"{plan.buckets[0].MP}x{plan.buckets[0].KP}")
    for r in (64, 128, 300):
        X = torch.randn((shape[0], r), generator=gen).to(DEV)
        for tr in (False, True):
            got = patch_engine.bucket_spmm(vals, cc, rs, X, shape[0], transpose=tr)
            ref = patch_engine.bucket_spmm_plain(vals, cc, rs, X, shape[0], transpose=tr)
            torch.cuda.synchronize()
            err = rel_check(f"B2 {'transpose' if tr else 'forward'} r={r}",
                            got, ref, TOL[torch.float32])
            errs["B2"] = max(errs["B2"], err)
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
    plan, dev = A._patch_for()
    require(patch_wins(plan, [(A.layout, 1)], 64), "flagship r=64 must take the patch route")

    # kernels against their plain versions at the flagship's shapes
    errs = {"B1": 0.0, "B2": 0.0}
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
            errs["B2"] = max(errs["B2"], rel_check(
                f"B2 {'transpose' if tr else 'forward'} r=64", got, ref, TOL[torch.float32]))

    # the main path, counted
    products = [
        ("A @ X", lambda: A @ X, S @ Xn.astype(np.float64), "B2"),
        ("A @ x", lambda: A @ x, S @ xn.astype(np.float64), "B1"),
        ("A.T @ x", lambda: A.T @ x, S.T @ xn.astype(np.float64), "B1"),
        ("A.H @ X", lambda: A.H @ X, S.T @ Xn.astype(np.float64), "B2"),
        ("A.axpby(x, y, 2.0, 0.5)", lambda: A.axpby(x, y, 2.0, 0.5),
         2.0 * (S @ xn.astype(np.float64)) + 0.5 * yn.astype(np.float64), "B1"),
        ("(A @ A) @ x", lambda: (A @ A) @ x,
         S @ (S @ xn.astype(np.float64)), "B1"),
    ]
    reset_counts()
    outs = []
    for name, fn, _ref, kernel in products:
        before = counts()[kernel]
        outs.append(fn())
        require(counts()[kernel] > before, f"{name}: kernel {kernel} was not launched")
    torch.cuda.synchronize()
    launches = counts()
    print(f"  main-path launches: {launches}")
    for (name, _fn, ref, _k), out in zip(products, outs):
        rel_check(f"{name} vs float64 scipy", out, ref, TOL[torch.float32])
    require(launches["B1"] > 0 and launches["B2"] > 0,
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
        require(grown["B2" if r > 1 else "B1"] >= 2,
                f"{name}: backward did not run the kernel ({grown})")
    return errs, launches


# -- phase 3 -------------------------------------------------------------------

def phase3(card: str):
    print("phase 3: real size n=8192, 2000 x 128x128 f32 (config-1 recipe)")
    A, vrng = contiguous_operator(8192, 2000, 128, seed=7, value_seed=7 + 7777,
                                  device=DEV)
    value_bytes = sum(int(b.values.nbytes) for b in A.layout.buckets)
    print(f"  {A}; {value_bytes / 1e6:.1f} MB of bucket values")
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(8192, generator=gen).to(DEV)
    X = torch.randn((8192, 128), generator=gen).to(DEV)
    reset_counts()
    y = A @ x
    Y = A @ X
    torch.cuda.synchronize()
    launched = counts()
    print(f"  launches: SpMV + SpMM r=128 -> {launched}")
    require(launched["B1"] > 0 and launched["B2"] > 0,
            f"real-size products skipped a kernel: {launched}")
    rel_check("SpMV vs float64 plain", y, plain_route(A, x, dtype=torch.float64),
              TOL[torch.float32])
    rel_check("SpMM r=128 vs float64 plain", Y,
              plain_route(A, X, dtype=torch.float64), TOL[torch.float32])
    plan = A._patch_for()[0]
    times = {}
    for label, kern, plain, nbytes, flops in (
            ("SpMV", lambda: A @ x, lambda: plain_route(A, x), value_bytes,
             2 * value_bytes // 4),
            ("SpMM r=128", lambda: A @ X, lambda: plain_route(A, X),
             plan.value_bytes, 2 * plan.value_bytes // 4 * 128)):
        # plain, kernel, kernel, plain: both orders in one call
        p1, k1, k2, p2 = (median_ms(plain), median_ms(kern), median_ms(kern),
                          median_ms(plain))
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        k_dev, p_dev = graph_ms(kern), graph_ms(plain)
        times[label] = (k_ms, p_ms, k_dev, p_dev)
        print(f"  {label}: kernel route {k1:.4f} / {k2:.4f} ms, plain route "
              f"{p1:.4f} / {p2:.4f} ms (median of 25 CUDA-event repeats); "
              f"kernel {nbytes / (k_ms * 1e-3) / 1e9:.1f} GB/s "
              f"= {100 * nbytes / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1f}% of "
              f"3.35 TB/s, {flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s "
              f"[{card}]")
        print(f"  {label}: CUDA-graph replay (no host launch overhead) kernel "
              f"route {k_dev:.4f} ms = {nbytes / (k_dev * 1e-3) / 1e9:.1f} "
              f"GB/s = {100 * nbytes / (k_dev * 1e-3) / HBM_BYTES_PER_S:.1f}% "
              f"of 3.35 TB/s, {flops / (k_dev * 1e-3) / 1e12:.2f} TFLOP/s; "
              f"plain route {p_dev:.4f} ms; device idle share of the eager "
              f"kernel route {max(0.0, 1 - k_dev / k_ms):.2f} [{card}]")
    return times


def main() -> None:
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

    errs1 = phase1()
    errs2, launches = phase2()
    times = phase3(card)

    summary = {"kernels": [
        {"name": "fused_spmm (B1)", "route": "cuda", "source": B1_SRC,
         "replaces": B1_REPLACES, "launches": launches["B1"],
         "max_abs_err": errs2["B1"], "max_abs_err_phase1": errs1["B1"],
         "ms": times["SpMV"][0], "plain_ms": times["SpMV"][1],
         "graph_ms": times["SpMV"][2], "plain_graph_ms": times["SpMV"][3],
         "timed": "A @ x, n=8192, 2000 x 128x128 f32", "card": card},
        {"name": "patch_spmm (B2)", "route": "cuda", "source": B2_SRC,
         "replaces": B2_REPLACES, "launches": launches["B2"],
         "max_abs_err": errs2["B2"], "max_abs_err_phase1": errs1["B2"],
         "ms": times["SpMM r=128"][0], "plain_ms": times["SpMM r=128"][1],
         "graph_ms": times["SpMM r=128"][2],
         "plain_graph_ms": times["SpMM r=128"][3],
         "timed": "A @ X, n=8192, 2000 x 128x128 f32, r=128", "card": card},
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
