"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``torchdriveenv_tpu_torch/build/`` at first
use, then loaded with ``ctypes``. The library's file name carries a hash of
its source and flags, so an edited source is always rebuilt. All kernels
are compiled without multiply-add contraction (``--fmad=false``) so that
each stays bit-equal to its plain torch twin.

Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
KERNELS = ("rasterizer", "mapkit")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (not on PATH, nor under CUDA_HOME "
                           "or /usr/local/cuda): cannot build the CUDA kernels")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` each,
    all started together. Returns {name: nvcc's report} (``-Xptxas -v``:
    registers, shared memory, spills); empty for a library already built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {name: "" for name in names}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{reports[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load_rasterizer() -> ctypes.CDLL:
    """The rasterizer library (``tde_render_obs``), built at first use."""
    build(("rasterizer",))
    lib = ctypes.CDLL(library_path("rasterizer"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tde_render_obs.argtypes = ([vp] * 9 + [ci] * 5
                                   + [ctypes.POINTER(ctypes.c_float), vp])
    lib.tde_render_obs.restype = ci
    lib.tde_error_string.argtypes = [ci]
    lib.tde_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_mapkit() -> ctypes.CDLL:
    """The map compiler's library (``tde_stamp_segments``, ``tde_edt``),
    built at first use."""
    build(("mapkit",))
    lib = ctypes.CDLL(library_path("mapkit"))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.tde_stamp_segments.argtypes = [ci, cd, cd, cd, vp, ci] + [vp] * 4
    lib.tde_stamp_segments.restype = ci
    lib.tde_edt.argtypes = [ci] + [vp] * 5
    lib.tde_edt.restype = ci
    lib.tde_mapkit_error_string.argtypes = [ci]
    lib.tde_mapkit_error_string.restype = ctypes.c_char_p
    return lib
