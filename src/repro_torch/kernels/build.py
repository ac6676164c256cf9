"""Build the port's CUDA kernels from the package's own sources.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, never at import, into ``_build/`` beside this
module (git-ignored).  The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is; a finished build is moved into place atomically, so
processes that build at once do not see a half-written file.
``load_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

SOURCES = ("folb_aggregate", "flash_attention", "ssm_scan",
           "slstm_scan")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # name -> nvcc's output (ptxas register use)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an identical build exists; return
    (library path, compiler output)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            path, log = build(name)
            build_logs.setdefault(name, log)
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def load_all(names: Sequence[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Load every named library, compiling the missing ones in parallel
    (one ``nvcc`` process per source, all started together)."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {n: pool.submit(build, n) for n in names}
        for n, f in futures.items():
            log = f.result()[1]
            if log:
                build_logs[n] = log
    return {n: load(n) for n in names}
