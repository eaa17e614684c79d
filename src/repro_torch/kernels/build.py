"""Build the port's CUDA kernels from the repo's sources and load them.

At first use ``load(name)`` runs ``nvcc`` on every ``csrc/<name>.cu`` of
the repository — one process per source, all started together — into
``build/kernels/`` at the repository root, then loads the shared library
with ``ctypes`` (plain C entry points: no PyTorch headers, so a build takes
seconds, not minutes).  A library's file name carries a hash of its source,
the shared headers and the flags, so an edited kernel is rebuilt and a stale
one is never loaded.  Nothing is built from outside the repository.

Only the machine with the card has ``nvcc``; the CPU path never calls this
module (the wrappers in ``ops.py`` take the plain versions for CPU tensors).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("moe_gmm_ragged", "prefill_attention", "decode_attention",
           "moe_gmm", "paged_attention", "prefill_attention_bwd",
           "moe_gmm_bwd")
# headers a source may include: any edit rebuilds every kernel
HEADERS = ("common.cuh", "moe_swiglu.cuh", "hopper.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else /usr/local/cuda's,
    else the one on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in ((CSRC / f"{name}.cu").read_bytes(),
                 *((CSRC / hdr).read_bytes() for hdr in HEADERS),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; returns each kernel's
    ptxas report (registers, shared memory, spills).  Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        tmp.replace(out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def sass_counts(name: str, opcodes=("HGMMA", "UTMALDG")) -> Optional[Dict[str, int]]:
    """How often each SASS opcode occurs in kernel ``name``'s built
    library (``cuobjdump -sass``), or None where the toolkit has no
    cuobjdump.  Shows, for example, that a kernel's products run on wgmma
    (HGMMA) and its tiles arrive by TMA (UTMALDG)."""
    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    path = _lib_path(name)
    if not path.exists():
        build_all()
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all kernels first
    if this one is not built yet)."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]
