"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by plain ``nvcc`` for ``sm_90a`` into
a shared library with a C interface, at first use, and loaded with
``ctypes``.  A library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale one is never loaded.  The build
directory sits inside the package (``_build/``, ignored by git).

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc``.
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
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "conv3x3_chw": "conv3x3_chw.cu",
    "conv3x3_chw_dw": "conv3x3_chw_dw.cu",
    "percentile_mask": "percentile_mask.cu",
}

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then the
    toolkit directory PyTorch found."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, dict]:
    """Compile every named library that is not built yet, one ``nvcc``
    process per source, all started together.  Returns ``{name:
    {"seconds", "log"}}`` for the ones compiled here (``log`` is nvcc's
    output, with ptxas's register and shared-memory report).  Raises if a
    compile fails, after every started compile has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.is_file():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, target, t0) in started.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return done


def raise_on_error(name: str, rc: int, what: str) -> None:
    """Raise if a C launcher of library ``name`` returned a CUDA error
    (``rc`` != 0), with the error's text from ``<name>_error_string``."""
    if rc == 0:
        return
    msg = getattr(load(name), f"{name}_error_string")
    msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
    raise RuntimeError(f"{name}: launch failed with CUDA error {rc} "
                       f"({msg(rc).decode()}) for {what}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
