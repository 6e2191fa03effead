"""Worker process for tests/test_torch_multihost.py (not a pytest module).

Each OS process is one member of a CPU cluster holding 8 / nproc CPU
shards (8 in all).  Every process builds the same chain-coupled block
matrix with the port, distributes it over the global mesh, and runs
forward, transpose and r = 8 products whose halo rounds cross the process
boundaries over gloo.  Checked against scipy on every process.  Imports
neither jax nor the JAX package, as on a machine without them.

Usage: python tests/torch_multihost_worker.py <pid> <nproc> <port>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from blocksparse_tpu_torch.parallel import multihost

    # 8 shards regardless of the process count: 2 procs x 4 local (one
    # boundary) or 4 procs x 2 local (a ring with four process edges)
    local = 8 // nproc
    multihost.cpu_local_cluster(num_local_devices=local)
    multihost.init(f"127.0.0.1:{port}", nproc, pid)

    import blocksparse_tpu_torch as bt
    from blocksparse_tpu_torch.parallel.distributed import distribute

    # identical fixture on every process (same-on-all-ranks contract)
    rng = np.random.default_rng(42)
    n, group = 2048, 256
    blocks, rows, cols = [], [], []
    for g in range(n // group):
        r0 = g * group
        blocks.append(rng.standard_normal((group, group)).astype(np.float32))
        rows.append(np.arange(r0, r0 + group))
        cols.append(np.arange(r0, r0 + group))
        if g:  # couple neighbour groups: every shard boundary is crossed,
            # including the process boundaries
            blocks.append(
                rng.standard_normal((group, group)).astype(np.float32))
            rows.append(np.arange(r0, r0 + group))
            cols.append(np.arange(r0 - group, r0))
    A = bt.BlockSparseMatrix(blocks, rows, cols, (n, n), device="cpu")
    S = bt.to_scipy(A)

    mesh = multihost.global_row_mesh()
    assert mesh.size == local * nproc and mesh.multiprocess, mesh
    D = distribute(A, mesh)

    x = rng.standard_normal(n).astype(np.float32)
    xg = multihost.replicate(x, mesh)

    def relerr(got, ref):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        scale = max(1.0, float(np.abs(ref).max()))
        return float(np.abs(got - ref).max()) / scale

    err_f = relerr(D @ xg, S @ x)
    err_t = relerr(D.T @ xg, S.T @ x)
    r = 8
    X = rng.standard_normal((n, r)).astype(np.float32)
    err_m = relerr(D @ multihost.replicate(X, mesh), S @ X)

    halo = D.exchanged_bytes_per_call
    print(f"proc {pid}: world={dist.get_world_size()} shards={mesh.size} "
          f"fwd_rel={err_f:.2e} t_rel={err_t:.2e} mm_rel={err_m:.2e} "
          f"halo_bytes={halo}", flush=True)
    tol = 1e-5  # f32 relative (256-wide dot products)
    ok = err_f < tol and err_t < tol and err_m < tol
    print(f"proc {pid}: {'OK' if ok else 'FAIL'}", flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
