"""Nothing the command imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``blocksparse_tpu`` (compared whole: ``blocksparse_tpu_torch``
is the program)."""

import ast
import subprocess
import sys

from gpubench import harness

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
import runpy
run = runpy.run_path({run!r}, run_name="gpubench_run")
from gpubench import harness, calibrate
for cell in [w["name"] for w in harness.benchmark()["workloads"]]:
    harness.run_cell(cell, 2**31 + 5, 0.2, True, device="cpu",
                     overrides={{"n": 1024}})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = PROBE.format(root=str(harness.ROOT), run=str(harness.HERE / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.splitlines()[-2])
    assert "blocksparse_tpu_torch" in tops and "gpubench" in tops
    assert not set(tops) & set(harness.FORBIDDEN)
    assert out.stdout.splitlines()[-1] == "FORBIDDEN []"


def test_no_source_under_the_benchmark_imports_them():
    for path in harness.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "blocksparse_tpu_torch_fake", sys)
    assert "blocksparse_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "blocksparse_tpu.fake", sys)
    assert "blocksparse_tpu" in harness.forbidden_modules()
