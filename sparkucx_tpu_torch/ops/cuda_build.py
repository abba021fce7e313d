"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface (``extern "C"`` launchers
taking raw pointers, sizes and a stream) and is compiled by ``nvcc`` into its
own shared library, loaded with ``ctypes``.  Nothing is built at import time:
the first launch builds, and ``build_all`` builds every source at once, one
``nvcc`` process per source, all started together.

Libraries land in ``sparkucx_tpu_torch/_build/<hash>/`` where the hash covers
the sources and the flags, so an edited source rebuilds and an unchanged one
is reused.  ``nvcc`` is looked up under ``$CUDA_HOME``, then
``/usr/local/cuda``, then ``PATH``.
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
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"

#: library name -> its source file under csrc/
SOURCES: Dict[str, str] = {"block_copy": "block_copy.cu", "radix_sort": "radix_sort.cu"}

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}  #: guarded by _lock
#: seconds the last ``build_all`` spent compiling (0.0 when every library was reused)
last_build_seconds = 0.0
#: ptxas resource report per library from the last build (``-Xptxas -v``)
last_build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """``_build/<hash of every source and the flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        h.update(name.encode())
        h.update((CSRC_DIR / SOURCES[name]).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every missing library in parallel; returns name -> path."""
    global last_build_seconds
    names = sorted(SOURCES) if names is None else names
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    t0 = time.monotonic()
    procs = []
    staging = out / f"tmp-{os.getpid()}"
    staging.mkdir(exist_ok=True)
    for n in todo:
        tmp = staging / paths[n].name  # renamed into place once complete
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
        procs.append((n, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        last_build_log[n] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
            continue
        os.replace(tmp, paths[n])
    shutil.rmtree(staging, ignore_errors=True)
    if todo:
        last_build_seconds = time.monotonic() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _libraries[name] = lib
        return lib
