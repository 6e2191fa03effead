"""Readings from which a cell's limits are set; not part of a run.

    python3 gpubench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3 \
        [--control-seeds 4,5,6] [--block-jacobi] [--set KEY=VALUE ...]

For each of ``--seeds``, one run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the check), all in one process, so the
port's build is loaded once.  For each of ``--control-seeds``, the control:
the reference in the program's place at the nearest precision below the
configuration's (``check.control_readings``), on the right-hand sides or
operands a run of that seed draws.  ``--block-jacobi`` times the port's
``precond.block_jacobi`` once on the first seed's operator.  ``--set``
overrides a key of the configuration (a number), for sizing.  One JSON
line per reading on standard output.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from gpubench import check, harness  # noqa: E402
from gpubench.loops import LOOPS  # noqa: E402


class _Inputs:
    """What a loop needs to draw a seed's right-hand sides or operands,
    without the program's operator."""

    def __init__(self, n, dtype, device):
        self.n, self.dtype, self.device, self.op = n, dtype, device, None

    def precond(self):
        return None


def control(name: str, seed: int, overrides: dict, device,
            root=harness.ROOT) -> dict:
    bench = harness.benchmark(root)
    wl = harness.workload(bench, name)
    cfg = {**harness.config(wl["config"]), **overrides}
    mix = harness.mix(wl["traffic"])
    gen = harness.generator(cfg)
    st = gen.structure(cfg)
    points = gen.jittered_points(st, cfg, seed, device)
    ref = gen.reference_of(cfg, st, points)
    loop = LOOPS[mix["loop"]](_Inputs(st.n, gen.STORED[cfg["dtype"]], device),
                              mix, seed)
    ops = ([loop.rhs() for _ in range(int(mix["sample"]))]
           if mix["loop"] == "solve" else loop.pool)
    return check.control_readings(ref, mix["loop"], mix, ops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--block-jacobi", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args()
    overrides = {k: json.loads(v) for k, v in (s.split("=", 1) for s in args.set)}
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds,
                               bool(args.trace), t_start=t0, overrides=overrides)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", "overrides": overrides, **out}),
              flush=True)
    if args.block_jacobi and seeds:
        import blocksparse_tpu_torch as bt

        wl = harness.workload(harness.benchmark(), args.workload)
        cfg = {**harness.config(wl["config"]), **overrides}
        system = harness.generator(cfg).setup(cfg, seeds[0], device, harness.log)
        torch.cuda.synchronize()
        t = time.perf_counter()
        bt.block_jacobi(system.op)
        torch.cuda.synchronize()
        print(json.dumps({"workload": args.workload, "block_jacobi_s":
                          time.perf_counter() - t, "n": system.n}), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t = time.perf_counter()
        nums = control(args.workload, seed, overrides, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control", "numbers": nums,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
