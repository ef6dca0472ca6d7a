"""Build the port's CUDA kernels into one shared library, at first use.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
each compiles in seconds. Each source goes to its own ``nvcc`` process, all
started together, and the objects are linked into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -c <source> -o <object>
    nvcc -shared <objects> -o librepro_torch_kernels.so

``-fmad=false`` keeps the compiler from contracting a multiply and an add
into an FMA (the kernels also use the round-to-nearest intrinsics
explicitly). ``--use_fast_math`` is never used: it flushes subnormals and
approximates division.

The library goes into ``_build/<hash of sources, headers and flags>/``
beside this file (listed in ``.gitignore``); a changed source builds a new
one. The library is loaded with ``ctypes``; every pointer and the stream
are ``c_void_p``.
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
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("spmv_ell.cu", "factor_wavefront.cu", "tri_solve_wavefront.cu",
           "inverse_chain.cu", "panel_update.cu", "trsm.cu", "tile_lu.cu",
           "epoch_sweep.cu", "superstep_factor.cu")
HEADERS = ("level_row.cuh", "tile_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP, _PP = ctypes.POINTER(_I), ctypes.POINTER(_P)
_SIGNATURES = {
    "spmv_ell_launch": [_P] * 4 + [_I] * 4 + [_P],
    "factor_wavefront_launch": [_P] * 4 + [_I] * 4 + [_P],
    "factor_wavefront_chain_floor_launch": [_I, _I, _P, _P, _P],
    "factor_wavefront_threads": [_I, _I],
    "tri_solve_sweep_config": [_I] * 7 + [_IP],
    "tri_solve_wavefront_launch": [_PP, _IP] + [_P] * 4 + [_I, _P],
    "tri_solve_chain_floor_launch": [_I] * 3 + [_P] + [_P],
    "inverse_chain_launch": [_P] * 7 + [_I] * 4 + [_P],
    "panel_update_launch": [_P] * 4 + [_I] * 4 + [_P],
    "panel_update_slots_launch": [_P] * 4 + [_I] * 3 + [_P],
    "trsm_right_upper_launch": [_P] * 4 + [_I] * 5 + [_P],
    "trsm_left_unit_lower_launch": [_P] * 4 + [_I] * 5 + [_P],
    "tile_lu_launch": [_P] * 2 + [_I] + [_P],
    "tile_lu_chain_floor_launch": [_I, _P, _P],
    "epoch_sweep_launch": [_P] * 5 + [_I] * 9 + [_P],
    "epoch_sweep_apply_launch": [_PP, _IP] + [_P] * 5 + [_I, _P],
    "epoch_sweep_max_owners": [_I, _IP],
    "epoch_sweep_chain_floor_launch": [_I] * 3 + [_P] * 4,
    "superstep_factor_launch": [_P] * 6 + [_I] * 10 + [_P],
    "superstep_factor_persistent_launch": [_PP, _IP, _P, _P, _I, _P],
    "superstep_factor_max_owners": [_IP, _I, _IP, _IP],
    "superstep_factor_chain_floor_launch": [_I] * 3 + [_P] * 3,
}

_lock = threading.Lock()
_lib = None
_loads = 0  # libraries loaded by this process (see load_count)


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile and link the kernels unless this exact build exists; returns
    the library's path. ``build.log`` beside it keeps the compiler's output
    (registers, shared memory and spills per kernel, from ``-Xptxas -v``)."""
    so = library_path()
    if so.exists():
        return so
    out = so.parent
    out.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [out / f"{Path(name).stem}.{tag}.o" for name in SOURCES]
    procs = [
        subprocess.Popen([cc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)
    ]
    logs, failed = [], []
    for name, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        logs.append(f"== {name} (exit {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    tmp = out / f"{LIB_NAME}.{tag}"
    link = subprocess.run([cc, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    (out / "build.log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent build of the same sources is harmless
    return so


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib, _loads
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
            _loads += 1
    return _lib


def load_count() -> int:
    """Kernel libraries this process has loaded (built or found): 0 before
    the first launch, 1 after (the serve layer's compile watch counts it)."""
    with _lock:
        return _loads
