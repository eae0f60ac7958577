"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``extern "C"``), loaded with
``ctypes``.  Builds happen at first use, into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``); the file name carries a
hash of the sources and flags, so an edited source builds anew, and
the ``ptxas`` report of its build lies beside it (:func:`ptxas_report`).
:func:`build` compiles every stale source at once, one ``nvcc`` process
per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("frontier", "serve", "attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def ptxas_report(name: str) -> str:
    """The ``nvcc -Xptxas -v`` report (registers, shared memory, spills
    of every kernel) of the library built from ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".ptxas").read_text()


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every source in ``names`` whose library or report is
    missing.

    Returns, per compiled source, its build seconds.  Waits for every
    ``nvcc`` it started before raising on the first failure.
    """
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists() and out.with_suffix(".ptxas").exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        started[name] = (proc, tmp, out)
    report, failures = {}, []
    for name, (proc, tmp, out) in started.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            failures.append(f"nvcc failed on {name}.cu:\n{stdout}{stderr}")
            continue
        out.with_suffix(".ptxas").write_text(stderr.strip())
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0}
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
