"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
``ctypes``.  Libraries land in ``build/ocp_torch_kernels/`` beside the
package (git-ignored), named by a hash of the source, the headers under
``csrc/`` and the flags so a stale build is never picked up.  Nothing here runs at import: the package
imports on machines without ``nvcc`` or a GPU.

Several sources build in parallel: one ``nvcc`` process each, all started
together (:func:`build`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build", "load_library", "ptxas_log"]

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "ocp_torch_kernels"
SOURCES: Dict[str, Path] = {
    "banded_chunk": _PKG / "csrc" / "banded_chunk.cu",
    "banded_rolled_chunk": _PKG / "csrc" / "banded_rolled_chunk.cu",
    "banded_cr_chunk": _PKG / "csrc" / "banded_cr_chunk.cu",
    "shared_chunk": _PKG / "csrc" / "shared_chunk.cu",
    "shared_chunk_tc": _PKG / "csrc" / "shared_chunk_tc.cu",
    "admm_device_loop": _PKG / "csrc" / "admm_device_loop.cu",
}
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Round every multiply and add on its own, as the plain PyTorch
    # versions (and the JAX reference) do: no FMA contraction.
    "-fmad=false",
    "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
        "compiled at first use and need the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    # The headers the sources include (csrc/*.cuh) are part of every build.
    for header in sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet.

    Starts one ``nvcc`` per source at once and waits for all of them.
    Returns ``{name: seconds}`` for the ones compiled now; raises with the
    compiler's output if any fails.  ``ptxas -v`` (registers, spills) goes
    to ``<lib>.log`` beside each library.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    failed = []
    seconds = {}
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def ptxas_log(name: str) -> str:
    """``nvcc``/``ptxas -v`` output of the last build of ``name``."""
    p = _lib_path(name)
    log = p.with_name(p.name + ".log")
    return log.read_text() if log.exists() else ""
