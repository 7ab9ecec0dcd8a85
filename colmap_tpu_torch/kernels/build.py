"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``colmap_tpu_torch/csrc/*.cu`` is compiled for Hopper (``sm_90a``),
one nvcc process per source, all started together, and the objects are
linked into one shared library with a plain C interface. The library lands
in ``colmap_tpu_torch/_build/`` (listed in .gitignore) under a name keyed by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built at import time: the first
kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return str(cand)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _key() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            log = open(Path(tmp) / (src.stem + ".log"), "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
            objs.append(str(obj))
        failed = []
        for src, log, proc in procs:
            rc = proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
            (BUILD_DIR / (src.stem + ".ptxas.log")).write_text(text)
            if rc != 0:
                failed.append(f"{src.name} (rc {rc}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / target.name
        subprocess.run([nvcc, "-shared", "-o", str(tmp_so), *objs], check=True)
        os.replace(tmp_so, target)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    target = BUILD_DIR / f"libcolmap_tpu_torch_{_key()}.so"
    if not target.exists():
        _build(target)
    return ctypes.CDLL(str(target))
