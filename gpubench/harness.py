"""The harness: it finds a cell's configuration, traffic mix, limits and
per-layer readers by the names in ``BENCHMARK.json``, runs the cell and
builds its result line.

- configuration ``<config>``: ``configs/<config>.json``, whose
  ``generator`` names a module ``configs/<generator>.py`` with
  ``setup(cfg, seed, device, log)``;
- traffic mix ``<traffic>``: ``traffic/<traffic>.json``, read by
  ``loops.py``;
- per-layer metric ``<name>``: ``metrics/<name>.py`` with ``read(rec)``,
  which returns the metric or None where it finds nothing to read;
- the limits of cell ``<workload>``: ``limits/<workload>.json``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import check, trace
from .loops import LOOPS
from .roofline import product_bound

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "blocksparse_tpu")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def mix(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def limits(name: str, here: Path = HERE) -> dict:
    path = here / "limits" / f"{name}.json"
    return load_json(path) if path.exists() else {}


def generator(cfg: dict):
    return importlib.import_module(f"gpubench.configs.{cfg['generator']}")


def reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, wl: str, traced: bool) -> list:
    """The metrics a cell reports: its end-to-end metrics (those listing
    it, or listing no cells), or with a trace the per-layer ones listing
    it."""
    if traced:
        return [m for m in bench["per_layer"] if wl in m["workloads"]]
    return [m for m in bench["end_to_end"] if wl in m.get("workloads", [wl])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def bounds(system, rec: dict) -> dict:
    """The logical bound in seconds of one product of each operator the
    window called, and what bounds it."""
    r = rec.get("columns", 1)
    out = {}
    for which, calls in rec.get("calls", {}).items():
        if calls:
            w = system.work(which)
            out[which] = product_bound(w["stored"], w["logical"], w["rows"],
                                       w["cols"], r, w["dtype"], w["tier"])
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: float | None = None, overrides=None,
             here: Path = HERE, root: Path = ROOT) -> dict:
    """One run of cell ``name``: set-up, warm-up, the window, the check.
    Returns the result line (a dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    bench = benchmark(root)
    wl = workload(bench, name)
    cfg = {**config(wl["config"], here), **(overrides or {})}
    traffic = mix(wl["traffic"], here)
    entered = time.perf_counter()
    system = generator(cfg).setup(cfg, seed, device, log)
    loop = LOOPS[traffic["loop"]](system, traffic, seed)
    warm = time.perf_counter()
    loop.warm_up()
    setup_s = time.perf_counter() - t_start
    system.phases["start_s"] = entered - t_start
    system.phases["warmup_s"] = t_start + setup_s - warm
    log(f"set-up {setup_s:.3f} s: {system.phases}")
    if traced:
        with trace.profiler() as prof:
            with trace.span(trace.WINDOW):
                rec = loop.window(float(traffic["trace_seconds"]), True)
        rec["trace"] = trace.reduce(prof)
        rec["bounds"] = bounds(system, rec)
        log(f"trace {json.dumps({k: v for k, v in rec['trace'].items() if k != 'breakdown'})}")
    else:
        rec = loop.window(seconds, False)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"window {rec['window_s']:.3f} s, {rec['units']} units, "
        f"launches {rec['launches']}, per second {rec['per_second']}")
    if rec.get("enqueue_s"):
        q = sorted(rec["enqueue_s"])
        log(f"enqueue ms: mean {1e3 * sum(q) / len(q):.4f}, "
            f"median {1e3 * q[len(q) // 2]:.4f}")
    answers = loop.answers()
    loop.free()
    system.free()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.readings(system.reference(), traffic["loop"], answers, rec)
    log(f"check took {time.perf_counter() - t:.3f} s")
    correct, checks = check.judge(numbers, limits(name, here))
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        if traced:
            value = reader(m["name"], here)(rec)
        else:
            value = setup_s if m["name"] == "setup_s" else rec["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": rec["units"],
           "failed": rec.get("unconverged", 0), "metrics": metrics,
           "device": dev}
    if traced:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = checks
    return out
