"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a`` -- one ``nvcc`` per
source, all started together -- and linked into one shared library with a
plain C interface, at first kernel use (never at import), into
``blocksparse_tpu_torch/_build/``.  The library's name carries a hash of the
sources and flags, so an edit to any source rebuilds it.  It is loaded with
ctypes; every entry point returns the ``cudaError_t`` of its launch.

A missing ``nvcc`` or a failed build raises with the compiler's output:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["load_library", "build_info", "check", "launch"]

_PKG = Path(__file__).resolve().parents[1]
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the (stored, compute) instances of B1 and B9's element pass, owner mode
# and colored products pass
_VALUE_SUFFIXES = ("f32", "f64", "c64", "c128", "bf16_f32", "bf16_f64",
                  "f32_f64", "c64_c128")
_SIGNATURES = {
    # vals, row_tab, col_tab, x, y, nb, mp, kp, C, r, x_rows, y_rows, mode,
    # stream
    **{f"bst_fused_spmm_{suffix}": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _L, _L, _I, _P)
       for suffix in _VALUE_SUFFIXES},
    # table, n, items, x, y, r, x_rows, y_rows, mode, stream
    **{f"{entry}_{suffix}": (_P, _I, _L, _P, _P, _I, _L, _L, _I, _P)
       for entry in ("bst_fused_spmm_multi", "bst_element_pass",
                     "bst_fused_spmm_rows", "bst_element_pass_rows")
       for suffix in _VALUE_SUFFIXES},
    # table, n, items, poff, x, P, r, x_rows, p_rows, mode, stream
    **{f"bst_element_owner_products_{suffix}": (_P, _I, _L, _P, _P, _P, _I,
                                                _L, _L, _I, _P)
       for suffix in _VALUE_SUFFIXES},
    # rows, ptr, flat, n_rows, P, y, r, y_rows, stream
    **{f"bst_element_owner_sum_{suffix}": (_P, _P, _P, _L, _P, _P, _I, _L, _P)
       for suffix in ("f32", "f64", "c64", "c128")},
    # table, n, items, owner, ifirst, bstart, poff_f, poff_m, woff, W, cnt,
    # x, x_rows, P, mode, stream
    **{f"bst_colored_products_r1_{suffix}": (_P, _I, _L, _P, _P, _P, _P, _P,
                                             _P, _P, _P, _P, _L, _P, _I, _P)
       for suffix in _VALUE_SUFFIXES},
    # tables, ncolors, out_len, total, P, y, r, stream
    **{f"bst_colored_rounds_{suffix}": (_P, _I, _L, _L, _P, _P, _I, _P)
       for suffix in ("f32", "f64", "c64", "c128")},
    # B1's tensor-core instances: table, n, items_f, items_t, x, y, r,
    # x_rows, y_rows, mode, stream
    **{f"bst_fused_spmm_mma_{suffix}": (_P, _I, _L, _L, _P, _P, _I, _L, _L,
                                        _I, _P)
       for suffix in ("c64", "f64", "c128", "bf16_f32")},
    # x, hi, lo, P, n, r, ld, stream
    "bst_patch_xt_f32": (_P, _P, _P, _I, _L, _I, _L, _P),
    # vals, cc, rs, xt_hi, xt_lo, y, nb, MP, KP, r, x_rows, ld, y_rows, tier,
    # stream
    "bst_patch_spmm_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                           _I, _P),
    # vals, cc, rs, xt_hi, xt_lo, y, P, nb, MP, KP, r, x_rows, ld, y_rows,
    # tier, stream
    "bst_patch_spmm_tr_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L,
                              _L, _L, _I, _P),
    # P, nb, MP, KP, r, tier, sms, out (no stream: a host query)
    "bst_patch_tr_geometry": (_I, _I, _I, _I, _I, _I, _I, _P),
    # vals, cc, rs, mk, own_chunk, own_ptr, own_pair, n_own, x, y, nb, MP,
    # KP, r, n, adjoint, tier, stream
    "bst_patch_sym_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                          _I, _L, _I, _I, _P),
    # x, n, idx, K, out, stream
    "bst_mask_gather_f32": (_P, _L, _P, _L, _P, _P),
    # v, idx, K, y, out_len, stream
    "bst_mask_scatter_add_f32": (_P, _P, _L, _P, _L, _P),
    # vals, rid8, cid8, segid, otgt, b8, x, y, ntiles, TS, CW, RW, NC32,
    # ngrids, grids, ncols, nrows, mirror, tiles per block, stream
    "bst_panel_spmv_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                           _I, _I, _L, _L, _L, _I, _L, _P),
    # ntiles, CW, mirror, out (a host query on the current card)
    "bst_panel_spmv_geometry": (_L, _I, _I, _P),
    # vals, cc, rs, x, y, P, nb, MP, KP, r, x_rows, y_rows, tier, stream
    "bst_batched_spmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                             _I, _P),
    # as bst_panel_spmv_f32 with P after y
    "bst_panel_spmv_batched_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                                   _I, _I, _I, _I, _I, _L, _L, _L, _I, _I,
                                   _P),
    # vals, rid8, cid, flag, b8, x, y, ntiles, TS, RW, ncols, nrows, mirror,
    # tpw, stream
    "bst_slab_spmv_f32": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _I,
                          _I, _P),
    # vals, cc, rs, mk, tiles, ntiles, x, y, nb, MP, KP, n_in, n_out, mode,
    # tiles per block, stream
    "bst_patch_spmv1_f32": (_P, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _L,
                            _L, _I, _L, _P),
    # ntiles, KP, mode, out (a host query on the current card)
    "bst_patch_spmv1_geometry": (_L, _I, _I, _P),
    # vals, rid8, cid8, segid, tgt, b8, x, y, ntiles, TS, CW, RW, seg, NC,
    # ncols, nrows, mirror, tiles per block, stream
    "bst_panel2_spmv_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                            _I, _I, _L, _L, _I, _L, _P),
    # ntiles, CW, seg, mirror, out (a host query on the current card)
    "bst_panel2_spmv_geometry": (_L, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the CUDA "
        "kernels of blocksparse_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(so: Path) -> None:
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [so.with_name(f"{tag}.{src.stem}.o") for src in _sources()]
    tmp = so.with_name(f"{tag}.so.tmp")
    t0 = time.perf_counter()
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    steps = [(cmd, proc.communicate()[0], proc.returncode)
             for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.stdout + proc.stderr, proc.returncode))
    _info["build_s"] = time.perf_counter() - t0
    _info["compiler_output"] = "".join(out for _, out, _ in steps)
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, so)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _BUILD_DIR / f"libbst_kernels_{_digest()}.so"
        _info["library"] = str(so)
        if so.exists():
            _info.setdefault("build_s", 0.0)
        else:
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bst_error_string.argtypes = (ctypes.c_int,)
        lib.bst_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_info() -> dict:
    """Library path, build seconds (0.0 when reused) and compiler output."""
    return dict(_info)


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().bst_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` with ``args`` and the current stream of
    ``device`` (a CUDA device), with ``device`` current; raise on error."""
    fn = getattr(load_library(), name)
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(err, name)
