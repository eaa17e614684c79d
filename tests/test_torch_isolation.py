"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package ``repro`` (nor ``msgpack``), its smoke serve runs with ``jax`` blocked, and
its entry points refuse to run without CUDA unless told to use the CPU."""

from __future__ import annotations

import ast
import json
import os
import runpy
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "examples" / "train_small_torch.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        # msgpack: the JAX package's checkpoint format; the port's
        # checkpoints are torch.save files (the card's machine has none)
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), \
            f"{path}: imports {mod}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_smoke_serve_runs_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.launch import serve\n"
            "serve.main(['--smoke', '--device', 'cpu', '--requests', '2'])\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] qwen3-30b-a3b-smoke x layered" in out.stdout
    assert "2 requests in" in out.stdout


def test_recurrent_smoke_serves_run_with_jax_blocked():
    """The recurrent mixers (models/rglru.py, models/xlstm.py) serve with
    ``jax`` and ``repro`` blocked too."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.launch import serve\n"
            "for arch in ('recurrentgemma-9b', 'xlstm-1.3b'):\n"
            "    serve.main(['--arch', arch, '--smoke', '--device', 'cpu',\n"
            "                '--requests', '2', '--max-len', '64'])\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for arch in ("recurrentgemma-9b", "xlstm-1.3b"):
        assert f"[serve] {arch}-smoke x layered" in out.stdout
    assert out.stdout.count("2 requests in") == 2


def test_dryrun_runs_with_jax_blocked(tmp_path):
    """The multi-device dry-run (``repro_torch.launch.dryrun``) imports
    neither ``jax`` nor ``repro``: with both blocked it traces
    xlstm-1.3b's ``long_500k`` decode at 16x16 (mLSTM and sLSTM under the
    mesh) and writes its JSON, and its mesh, shapes, steps and analysis
    modules import."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.launch import dryrun, steps, analysis, mesh\n"
            "from repro_torch.configs import shapes\n"
            "from repro_torch.sharding import collectives, partition, spmd\n"
            "dryrun.main(['--arch', 'xlstm-1.3b', '--shape',\n"
            "             'long_500k', '--out', sys.argv[1]])\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "xlstm-1.3b x long_500k x 16x16: ok" in out.stdout
    rec = json.loads((tmp_path / "xlstm-1.3b_long_500k_16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256


def test_entry_point_without_cpu_flag_raises_without_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--requests", "1"])


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path, capsys):
    """No CUDA here: the script must exit non-zero and print no result —
    from the repository, and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the script would really run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        with pytest.raises(SystemExit) as exit_:
            runpy.run_path(str(script), run_name="__main__")
        assert exit_.value.code not in (0, None)
        assert '"ok"' not in capsys.readouterr().out


def test_train_launcher_runs_with_jax_blocked():
    """The training launcher (``repro_torch.launch.train``) trains with
    ``jax``, ``repro`` and ``msgpack`` blocked, and refuses to run without
    CUDA unless told to use the CPU."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.launch import train\n"
            "train.main(['--smoke', '--device', 'cpu', '--steps', '2',\n"
            "            '--batch', '2', '--seq', '16', '--arch',\n"
            "            'qwen3-moe-235b-a22b', '--ckpt', sys.argv[1]])\n")
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([sys.executable, "-c", code, d + "/c.pt"],
                             env=_env(), cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] qwen3-moe-235b-a22b-smoke:" in out.stdout
    assert "[train] step     1 loss=" in out.stdout
    assert "[train] checkpoint -> " in out.stdout


def test_train_launcher_without_cpu_flag_raises_without_cuda(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


def test_train_small_example_runs_with_jax_blocked(tmp_path):
    """``examples/train_small_torch.py`` (the port of
    ``examples/train_small.py``) trains on the CPU with ``jax``, ``repro``
    and ``msgpack`` blocked, and refuses to run without CUDA unless told
    to use the CPU."""
    code = ("import runpy, sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
            "    sys.modules[m] = None\n"
            "ns = runpy.run_path(sys.argv[1])\n"
            "ns['main'](['--steps', '2', '--batch', '2', '--seq', '32',\n"
            "            '--device', 'cpu', '--ckpt', sys.argv[2]])\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(ROOT / "examples" / "train_small_torch.py"),
                          str(tmp_path / "c.pt")], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "minicpm-100m:" in out.stdout and "on cpu" in out.stdout
    assert "  step    1  loss " in out.stdout and "loss: " in out.stdout


def test_train_small_example_without_cpu_flag_raises_without_cuda(
        monkeypatch):
    ns = runpy.run_path(str(ROOT / "examples" / "train_small_torch.py"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ns["main"](["--steps", "1"])
