"""Build csrc/*.cu with nvcc on first use and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so one nvcc call
takes seconds.  It lands in gbp_tpu_torch/_build/<hash of the sources>/,
so an edited source rebuilds and an unchanged one loads the cached build.
nvcc is found through torch's CUDA_HOME; nothing outside the package's own
directory is written.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_ARGTYPES = {
    # cam_mean, n_cam, lmk_mean, nv, gidx, z, lp, jac, r0, srel, act,
    # olp, ojac, or0, osrel, mp, deg, beta, min_linear, stream
    "gbp_relin_cm_tab_ell": [_P, _I, _P, _I] + [_P] * 7 + [_P] * 4
    + [_I64, _I, _D, _D, _P],
    # cam_tab, n_cam, lmk_tab, nv, gidx, jac, lp, r0, prec, srel, act,
    # me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, deg, eta_damping,
    # lam_damping, num_undamped, floor, jitter, has_huber, huber, stream
    "gbp_messages_cm_tab_ell": [_P, _I, _P, _I] + [_P] * 7 + [_P] * 4 + [_P] * 4
    + [_I64, _I, _D, _D, _D, _D, _D, _I, _D, _P],
    # me, ml, rows, offsets, n_seg, mp, out, stream
    "gbp_segsum_by_id": [_P, _P, _P, _P, _I, _I64, _P, _P],
}


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet; returns
    (library path, seconds spent compiling, 0.0 when cached).  The
    compiler's -Xptxas -v report (registers, spills) is kept beside it as
    ptxas.txt."""
    out_dir = BUILD_DIR / _digest()
    lib = out_dir / "libgbp_kernels.so"
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Compile to a private name, then rename: a concurrent process never
    # sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cus = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    (out_dir / "ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry's argtypes declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for base, argtypes in _ARGTYPES.items():
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{sfx}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def ptxas_report() -> str:
    """The -Xptxas -v lines of the current build (empty before a build)."""
    p = BUILD_DIR / _digest() / "ptxas.txt"
    return p.read_text() if p.exists() else ""
