"""Builds the CUDA kernels with nvcc into shared libraries with a plain C
interface and loads them with ctypes.

Each `csrc/*.cu` becomes `build/kernels/<name>-<hash>.so` at the root of
the checkout, the hash taken over every source in `csrc/` and the flags,
so an edited source rebuilds and an unchanged one is reused. Nothing
here runs at import: the first launch (or `build_all`) compiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("rank_audited", "knn_rank_audited", "linear_rank_audited",
           "knn_lambda", "knn_lambda_quant", "knn_rank_audited_quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points: (argtypes, restype int = cudaError_t)
SIGNATURES = {
    "rank_audited": ("rank_audited_launch",
                     [_P] * 10 + [_I] * 5 + [_F, _F, _P]),
    "knn_rank_audited": ("knn_rank_audited_launch",
                         [_P] * 15 + [_I] * 12 + [_F, _F, _P]),
    "linear_rank_audited": ("linear_rank_audited_launch",
                            [_P] * 13 + [_I] * 7 + [_F, _F, _P]),
    "knn_lambda": ("knn_lambda_launch", [_P] * 6 + [_I] * 8 + [_P]),
    "knn_lambda_quant": ("knn_lambda_quant_launch",
                         [_P] * 9 + [_I] * 12 + [_P]),
    "knn_rank_audited_quant": ("knn_rank_audited_quant_launch",
                               [_P] * 18 + [_I] * 16 + [_F, _F, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp output, log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source not yet built, one nvcc per source,
    all started together. Returns {name: nvcc output} of the builds run
    (ptxas's registers, shared memory and spills per kernel)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES
                   if not library_path(n).exists()}
        return {n: _finish(n, *job) for n, job in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed, with
    its entry point's argtypes and restype declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point; raise if it reports an error."""
    fn_name, _ = SIGNATURES[name]
    err = getattr(load(name), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
