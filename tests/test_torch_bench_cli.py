"""The port's bench CLI (``sview_fmindex_tpu_torch/bench/cli.py``) against
the JAX package's (``sview_fmindex_tpu/bench/cli.py``).

One seeded text and one pattern file (cold 25%) are made by each CLI in its
own data directory; then ``build`` and ``locate`` run for every algorithm and
both block kinds.  Everything is compared byte for byte (tolerance: exact):
``text.txt``, ``pattern.txt``, the blobs of ``memory`` and ``mmap`` for Block3
and Block2 (``-t``), and the result files across {memory, mmap, device} x
{JAX, port}.  The port's ``device`` algorithm runs with ``--device cpu`` (the
join kernel's plain version); the JAX side runs on the CPU backend, where a
batch this small takes its gather engine.
"""
import os
import re
import shutil

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from sview_fmindex_tpu.bench import cli as jcli  # noqa: E402
from sview_fmindex_tpu_torch.bench import cli as tcli  # noqa: E402

TEXT_LEN, PATTERNS, COLD = 30_000, 200, 0.25
ALGOS = ("memory", "mmap", "device")
BLOCKS = {"block3": (), "block2": ("-t",)}


def _stem(algo, block):
    return f"sview-{'mmap' if algo == 'mmap' else 'memory'}-{block}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{side: {"dir", "results": {(algo, block): bytes}, "out": {(algo, block): str}}}"""
    import contextlib
    import io

    out = {}
    for side, cli, dev_args in (("jax", jcli, ()), ("port", tcli, ("--device", "cpu"))):
        d = str(tmp_path_factory.mktemp(f"cli_{side}"))
        printed = {}

        def run(*argv, key=None):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(list(argv))
            if key:
                printed[key] = buf.getvalue()

        run("generate-text", "-d", d, "-t", str(TEXT_LEN), "-s", "11")
        run("generate-pattern", "-d", d, "-n", str(PATTERNS), "-c", str(COLD), "-s", "12")
        results = {}
        for block, flag in BLOCKS.items():
            for algo in ("memory", "mmap"):
                run("build", "-d", d, "-a", algo, *flag)
            for algo in ALGOS:
                extra = dev_args if algo == "device" else ()
                run("locate", "-d", d, "-a", algo, *flag, *extra, key=(algo, block))
                with open(os.path.join(d, f"{_stem(algo, block)}-results.txt"), "rb") as f:
                    results[algo, block] = f.read()
        out[side] = dict(dir=d, results=results, out=printed)
    return out


def _read(runs, side, name):
    with open(os.path.join(runs[side]["dir"], name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["text.txt", "pattern.txt"])
def test_generated_files_byte_identical(runs, name):
    data = _read(runs, "port", name)
    assert data == _read(runs, "jax", name)
    if name == "text.txt":
        assert len(data) == TEXT_LEN and set(data) <= set(b"ACGT")
    else:
        pats = data.split(b"\n")
        assert len(pats) == PATTERNS and len(set(pats)) <= int(PATTERNS * COLD)


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("algo", ["memory", "mmap"])
def test_blobs_byte_identical(runs, algo, block):
    name = f"{_stem(algo, block)}.blob"
    blob = _read(runs, "port", name)
    assert blob == _read(runs, "jax", name)
    # the two stems hold the same index
    assert blob == _read(runs, "port", f"{_stem('memory', block)}.blob")


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("algo", ALGOS)
def test_results_byte_identical(runs, algo, block):
    """Across {memory, mmap, device} x {JAX, port}: one file."""
    got = runs["port"]["results"][algo, block]
    assert got == runs["jax"]["results"][algo, block]
    assert got == runs["port"]["results"]["memory", block]
    lines = got.split(b"\n")
    assert len(lines) == PATTERNS + 1 and lines[-1] == b""
    assert all(line for line in lines[:-1])  # every pattern was cut from the text


@pytest.mark.parametrize("algo", ALGOS)
def test_locate_prints_the_reference_lines(runs, algo):
    """The same printed lines as the JAX CLI, in the same order."""
    def shape(text):
        return [re.sub(r"\d+", "N", ln.replace("cli_port", "cli_").replace("cli_jax", "cli_"))
                for ln in text.splitlines()]

    port = shape(runs["port"]["out"][algo, "block3"])
    assert port == shape(runs["jax"]["out"][algo, "block3"])
    for want in ("Blob loading time: N ns", "Locate time: N ns", "Total time: N ns",
                 "Index Load (%): N"):
        assert want in port


def test_serve_mode_and_stable_result(runs, capsys):
    """``--serve N`` reports the resident rate and leaves the result file as
    the one-shot run wrote it."""
    d = runs["port"]["dir"]
    tcli.main(["locate", "-d", d, "-a", "device", "--device", "cpu", "--serve", "2"])
    out = capsys.readouterr().out
    assert re.search(r"Serve mode: 2 batches, \d+ ns/batch \([\d,]+ locate/s resident\)", out)
    assert _read(runs, "port", "sview-memory-block3-results.txt") == \
        runs["port"]["results"]["device", "block3"]


def test_device_algorithm_raises_without_a_card(runs, monkeypatch):
    """No ``--device`` and no CUDA device: an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["locate", "-d", runs["port"]["dir"], "-a", "device"])


def test_generate_is_both_steps(tmp_path):
    """The legacy ``generate`` subcommand writes both files, cold 100%."""
    for cli, sub in ((tcli, "t"), (jcli, "j")):
        cli.main(["generate", "-d", str(tmp_path / sub), "-t", "5000", "-n", "20", "-s", "5"])
    for name in ("text.txt", "pattern.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    shutil.rmtree(tmp_path / "t")
