"""Build and load the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library at first use and loaded
with ``ctypes``. Libraries land in ``build/repro_torch/`` at the repository
root (listed in ``.gitignore``), named by a hash of the source and the
flags (and of the shared headers ``csrc/*.cuh``), so an edited source
rebuilds and an unchanged one loads at once.
Every source is compiled by one ``nvcc`` process, all started together.
Nothing here runs at import time, and a failed build raises.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("paged_attention_splitk", "paged_attention", "chunked_prefill",
           "ssd_scan", "rglru_scan", "ssd_scan_bwd", "rglru_scan_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
# name -> nvcc's output of the build that produced the library (ptxas -v:
# registers, shared memory and spills per kernel); empty for a cached load
build_log: dict = {}
build_seconds: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(install the CUDA toolkit or set CUDA_HOME)")
    return cand


def _target(name: str) -> Path:
    # the key covers the headers too: a source may include any of them
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel and load all of them.
    Returns {name: ctypes.CDLL}. Raises on the first failed build."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        missing = [n for n in todo if not _target(n).exists()]
        procs = {}
        if missing:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            for n in missing:
                tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        failed = []
        for n, (tmp, t0, proc) in procs.items():
            out, _ = proc.communicate()
            build_seconds[n] = time.perf_counter() - t0
            build_log[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, _target(n))
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_target(n)))
            build_log.setdefault(n, "")
        return {n: _libs[n] for n in names}


def kernel_fn(lib_name: str, fn_name: str, argtypes):
    """The C entry ``fn_name`` of library ``lib_name``, built on first use,
    with its argument types declared (pointers and the stream as
    ``c_void_p``); it returns the ``cudaError_t`` of its launches."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        lib = _libs.get(lib_name) or build_all((lib_name,))[lib_name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
