"""Build the port's CUDA sources into shared libraries and load them.

Each ``ops/csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (``SRML_TORCH_BUILD_DIR`` overrides the directory), named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, and
loaded with ``ctypes``. A second process,
or a later run, finds the library already built. Nothing here runs on
import: the CPU-only machines that run the tests have no ``nvcc``.

The kernel ledger (``utils/xprof.py``) books a build's seconds to the
kernel whose call built the library (a compile), and counts a library
found already built (a persistent-cache hit).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

from spark_rapids_ml_tpu_torch.utils import xprof

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: ptxas report (registers, shared memory, spills) of each library built
#: by this process, by source name.
BUILD_LOGS: Dict[str, str] = {}

_lock = threading.Lock()


def build_dir() -> Path:
    default = Path(__file__).resolve().parents[2] / "build" / "kernels"
    return Path(os.environ.get("SRML_TORCH_BUILD_DIR") or default)


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``: a change to the source, to any
    shared header it may include or to the flags names another file."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        xprof.note_cache_hit()
        return out
    compiler = nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    cmd: List[str] = [compiler, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr}"
            )
        BUILD_LOGS[name] = proc.stderr
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        xprof.note_compile(time.perf_counter() - t0)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> List[Path]:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` per source."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    with _lock:
        return ctypes.CDLL(str(build(name)))
