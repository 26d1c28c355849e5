"""What the benchmark may load: no JAX and no JAX package in a run, nothing
of the program in the reference, and none of the repo's measuring scripts."""
import ast
import json
import os
import subprocess
import sys

from conftest import ROOT, small_args

FORBIDDEN = {"jax", "jaxlib", "flax", "sview_fmindex_tpu"}
BENCH = os.path.join(ROOT, "fmbench")


def test_a_run_loads_no_jax():
    """A fresh process of ``run.py`` on the CPU, its modules listed once
    the run has ended, top-level names compared whole."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['fmbench/run.py'] + {small_args('dna20-1e8.count-1m')!r}\n"
        "try:\n"
        "    runpy.run_path('fmbench/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="2"), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "sview_fmindex_tpu_torch" in modules
    assert not [m for m in modules if m.split(".")[0] in FORBIDDEN]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_and_judge_import_nothing_of_the_program():
    for name in ("reference.py", "judge.py"):
        tops = {m.split(".")[0] for m in _imports(os.path.join(BENCH, name))}
        assert tops <= {"__future__", "torch", "numpy"}, (name, tops)
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys; import fmbench.reference, fmbench.judge; "
         "print(json.dumps(sorted(sys.modules)))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    modules = json.loads(proc.stdout)
    assert not [m for m in modules if m.split(".")[0] in FORBIDDEN | {"sview_fmindex_tpu_torch"}]


def test_no_file_of_the_benchmark_reads_the_repos_measuring_scripts():
    scripts = ("bench_torch", "chip_smoke", "run_benchmark_torch", "tools")
    for dirpath, _, files in os.walk(BENCH):
        if "runs" in dirpath.split(os.sep) or "tests" in dirpath.split(os.sep):
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & (FORBIDDEN | set(scripts)), (path, tops)
            text = open(path).read()
            assert not any(f"{s}.py" in text or f"{s}/" in text for s in scripts), path
