"""The port's distributed layer across OS processes: 2 x 4 and 4 x 2 CPU
shards over gloo.

Mirrors ``tests/test_multihost.py``: the in-process suites shard over one
process's devices; this tier exercises what they cannot -- process-group
formation (``multihost.init``), meshes whose entries belong to other
ranks, halo rounds whose ring edges cross the process boundary
(``torch.distributed.batch_isend_irecv``) and the final all-gather.  The
workers (``tests/torch_multihost_worker.py``) import no jax.
"""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(nproc: int):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        # a worker that lost its peer blocks in the rendezvous or a
        # receive forever -- never leak it past the test
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-15:])
        assert p.returncode == 0, f"worker {pid} failed:\n{tail}"
        assert f"proc {pid}: OK" in out, f"worker {pid} output:\n{tail}"
        assert f"world={nproc} shards=8" in out


def test_two_process_cluster():
    """2 processes x 4 CPU shards: one process boundary; SpMV, transpose
    and SpMM r = 8 against scipy."""
    _run_cluster(2)


def test_four_process_cluster():
    """4 processes x 2 CPU shards: the halo ring crosses a process boundary
    at every other shard."""
    _run_cluster(4)
