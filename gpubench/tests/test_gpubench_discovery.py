"""A configuration, a traffic mix and a per-layer metric dropped in as new
files (and entries of BENCHMARK.json) are found by name and run, with no
edit to a file that is there."""

import json
import shutil

from gpubench import harness


def test_new_files_are_found_and_run(tmp_path):
    here = tmp_path / "gpubench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(harness.HERE / sub, here / sub,
                        ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    cfg = {**harness.config("bem_laplace_f32"), "n": 1024, "leaf_size": 64}
    (here / "configs" / "tiny_laplace.json").write_text(json.dumps(cfg))
    mix = {**harness.mix("bicgstab"), "solver": "cg", "sample": 3,
           "trace_seconds": 0.2}
    (here / "traffic" / "cg_tiny.json").write_text(json.dumps(mix))
    (here / "metrics" / "solves.count.py").write_text(
        "def read(rec):\n    return rec['units'] if rec.get('loop') == 'solve' else None\n")
    (here / "limits" / "tiny.cg.json").write_text(json.dumps(
        {"residual": {"limit": 3e-5}, "unconverged": {"limit": 0}}))
    bench = harness.benchmark()
    bench["workloads"].append({"name": "tiny.cg", "config": "tiny_laplace",
                               "traffic": "cg_tiny", "chips": 1, "why": "test"})
    for name in ("solve_ms", "solve_p95_ms"):
        bench["end_to_end"].append({"name": name, "unit": "ms", "better": "lower",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": ["tiny.cg"]})
    bench["per_layer"].append({"name": "solves.count", "unit": "solves",
                               "better": "higher", "source": "program_counter",
                               "layer": "solvers", "moves": "solve_ms",
                               "workloads": ["tiny.cg"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = harness.run_cell("tiny.cg", 2**31 + 3, 0.2, True, device="cpu",
                           here=here, root=tmp_path)
    assert out["metrics"]["solves.count"]["value"] == out["attempted"] >= 1
    assert "iterations.solve" not in out["metrics"]
    assert out["correct"] is True
    plain = harness.run_cell("tiny.cg", 2**31 + 3, 0.2, False, device="cpu",
                             here=here, root=tmp_path)
    assert set(plain["metrics"]) == {"solve_ms", "solve_p95_ms", "setup_s"}
    assert list(plain)[-1] == "checks"
