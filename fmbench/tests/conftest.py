"""Tests of the benchmark harness.  They run on the CPU (``run.py --device
cpu``, the kernels' plain versions) at small texts; the one marked ``cuda``
runs a cell on a card and skips without one."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN = os.path.join(ROOT, "fmbench", "run.py")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on a CUDA device of the PyTorch port; needs a GPU or self-skips")


# a small version of each cell: a 1e6 text, batches the CPU can answer
SMALL = {
    "dna20-1e8.locate-1m": ["--text-size", "1000000", "--batch", "32768"],
    "prot20-1e8.locate-mixed-1m": ["--text-size", "1000000", "--batch", "32768"],
    "dna20-1e8.serve-4k": ["--text-size", "1000000", "--batch", "2048"],
    "dna20-1e8.count-1m": ["--text-size", "1000000", "--batch", "32768"],
}


def run_cli(args, env=None, cwd=ROOT, script=RUN, timeout=600):
    """(exit code, stdout, stderr) of one run of ``run.py`` in a fresh process."""
    env = dict(os.environ, **(env or {}))
    env.setdefault("OMP_NUM_THREADS", "2")
    proc = subprocess.run([sys.executable, script, *args], capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def small_args(cell, seed=20260101, seconds="0.5", trace="0", extra=()):
    return ["--workload", cell, "--seed", str(seed), "--seconds", seconds, "--trace", trace,
            "--device", "cpu", *SMALL[cell], *extra]


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
