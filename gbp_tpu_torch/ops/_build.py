"""Build csrc/*.cu with nvcc on first use and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so nvcc takes
seconds; the sources compile side by side, one nvcc process each (the
heaviest instantiations have sources of their own for that), and are linked
into one library.  It lands in gbp_tpu_torch/_build/<hash of the
sources>/, so an edited source rebuilds and an unchanged one loads the
cached build.
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
# -fmad=false: no multiply-add is contracted, so a kernel rounds every
# operation as its plain PyTorch version does and the two agree to the last
# bits whatever the conditioning of a row's cavity (float32 cavities of
# two-view landmarks amplify a contraction's half-ulp past any fixed
# tolerance).  The kernels are bound by bytes and registers, not arithmetic.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_ARGTYPES = {
    # model, gslot, cam_mean, n_cam, lmk_mean, nv, gidx, z, args, lp, jac, r0,
    # srel, act, olp, ojac, or0, osrel, mp, deg, beta, min_linear, stream
    "gbp_relin_cm_tab_ell": [_I, _I, _P, _I, _P, _I] + [_P] * 8 + [_P] * 4
    + [_I64, _I, _D, _D, _P],
    # d0, d1, z, gslot, huber_row, cam_tab, n_cam, lmk_tab, nv, gidx, jac, lp,
    # r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, deg,
    # eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber,
    # stream
    "gbp_messages_cm_tab_ell": [_I] * 5 + [_P, _I, _P, _I] + [_P] * 7 + [_P] * 4 + [_P] * 4
    + [_I64, _I, _D, _D, _D, _D, _D, _I, _D, _P],
    # me, me_ld, ml, ml_ld, d, row_major, rows, offsets, n_seg, m, chunk, group,
    # part, out, stream
    "gbp_segsum_by_id": [_P, _I64, _P, _I64, _I, _I, _P, _P, _I, _I64, _I, _I, _P, _P, _P],
    # model, gslot, cam_mean, n_cam, lmk_mean, gidx, starts, win_w, z, args,
    # lp, jac, r0, srel, act, olp, ojac, or0, osrel, mp, deg, beta, min_linear,
    # stream
    "gbp_relin_cm_tabblk_ell": [_I, _I, _P, _I, _P, _P, _P, _I] + [_P] * 7 + [_P] * 4
    + [_I64, _I, _D, _D, _P],
    # d0, d1, z, gslot, huber_row, cam_tab, n_cam, lmk_tab, gidx, starts, win_w,
    # jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp,
    # deg, eta_damping, lam_damping, num_undamped, floor, jitter, has_huber,
    # huber, stream, info (NULL: launch; else int[7], the launch plan and no
    # launch, as for every windowed messages entry)
    "gbp_messages_cm_tabblk_ell": [_I] * 5 + [_P, _I, _P, _P, _P, _I] + [_P] * 6 + [_P] * 4
    + [_P] * 4 + [_I64, _I, _D, _D, _D, _D, _D, _I, _D, _P, _P],
    # me, ml, d, rows, offsets, n_tiles, w, mp, out, stream
    "gbp_segsum_cm_blk": [_P, _P, _I, _P, _P, _I, _I, _I64, _P, _P],
    # d, n_tiles, info[9]: segsum_cm_blk's launch (ops.messages.segsum_blk_plan)
    "gbp_segsum_cm_blk_plan": [_I, _I, _P],
    # part, starts, blk_tiles, blk_offsets, f, w, n_seg, out, stream
    "gbp_scatter_windows_cm": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    # d0, d1, z, row_major, prec_full, huber_row, in[14], in_ld[14], out[4],
    # out_ld[4], m, eta_damping, lam_damping, num_undamped, floor, jitter,
    # has_huber, huber, stream
    "gbp_messages_rows": [_I] * 6 + [_P] * 4 + [_I64, _D, _D, _D, _D, _D, _I, _D, _P],
    # model, row_major, in[8] (x z lp jac r0 srel act args), in_ld[8],
    # out[4], out_ld[4], m, beta, min_linear, stream
    "gbp_relin_rows": [_I, _I] + [_P] * 4 + [_I64, _D, _D, _P],
    # d0, d1, z, prec_full, huber_row, info[5]; model, info[5]: the row-major
    # (staged) kernel's rows per block, shared bytes per block, registers and
    # local-memory bytes per thread, resident blocks per SM
    "gbp_messages_rows_info": [_I] * 5 + [_P],
    "gbp_relin_rows_info": [_I, _P],
    # model, gslot, x_other, mtab, n_g, gidx, z, args, lp, jac, r0, srel, act,
    # olp, ojac, or0, osrel, mp, beta, min_linear, stream
    "gbp_relin_cm_tab": [_I, _I, _P, _P, _I, _P] + [_P] * 7 + [_P] * 4 + [_I64, _D, _D, _P],
    # d0, d1, z, gslot, huber_row, btab, n_g, gidx, be_o, bl_o, jac, lp, r0,
    # prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp, eta_damping,
    # lam_damping, num_undamped, floor, jitter, has_huber, huber, stream
    "gbp_messages_cm_tab": [_I] * 5 + [_P, _I, _P, _P, _P] + [_P] * 6 + [_P] * 4 + [_P] * 4
    + [_I64, _D, _D, _D, _D, _D, _I, _D, _P],
    # tab, f, deg, mp, out, stream
    "gbp_expand_ell_blk": [_P, _I, _I, _I64, _P, _P],
    # model, gslot, x_other, mtab, n_g, gidx, starts, win_w, z, args, lp, jac,
    # r0, srel, act, olp, ojac, or0, osrel, mp, beta, min_linear, stream
    "gbp_relin_cm_tabblk": [_I, _I, _P, _P, _I, _P, _P, _I] + [_P] * 7 + [_P] * 4
    + [_I64, _D, _D, _P],
    # d0, d1, z, gslot, huber_row, btab, n_g, gidx, starts, win_w, be_o, bl_o,
    # jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0, ol0, oe1, ol1, mp,
    # eta_damping, lam_damping, num_undamped, floor, jitter, has_huber, huber,
    # stream, info
    "gbp_messages_cm_tabblk": [_I] * 5 + [_P, _I, _P, _P, _I, _P, _P] + [_P] * 6 + [_P] * 4
    + [_P] * 4 + [_I64, _D, _D, _D, _D, _D, _I, _D, _P, _P],
    # model, gslot, cam_mean, n_cam, gtab, n_gt, lmk_mean, gidx, starts, win_w,
    # n_own, z, args, lp, jac, r0, srel, act, olp, ojac, or0, osrel, mp, deg,
    # beta, min_linear, stream
    "gbp_relin_cm_tabblkg_ell": [_I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I] + [_P] * 7
    + [_P] * 4 + [_I64, _I, _D, _D, _P],
    # d0, d1, z, gslot, huber_row, cam_tab, n_cam, gtab, n_gt, lmk_tab, gidx,
    # starts, win_w, n_own, jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1,
    # oe0, ol0, oe1, ol1, mp, deg, eta_damping, lam_damping, num_undamped,
    # floor, jitter, has_huber, huber, stream, info
    "gbp_messages_cm_tabblkg_ell": [_I] * 5 + [_P, _I, _P, _I, _P, _P, _P, _I, _I] + [_P] * 6
    + [_P] * 4 + [_P] * 4 + [_I64, _I, _D, _D, _D, _D, _D, _I, _D, _P, _P],
    # model, gslot, x_other, mtab, n_g, gtab, n_gt, gidx, starts, win_w, n_own,
    # z, args, lp, jac, r0, srel, act, olp, ojac, or0, osrel, mp, beta,
    # min_linear, stream
    "gbp_relin_cm_tabblkg": [_I, _I, _P, _P, _I, _P, _I, _P, _P, _I, _I] + [_P] * 7 + [_P] * 4
    + [_I64, _D, _D, _P],
    # d0, d1, z, gslot, huber_row, btab, n_g, gtab, n_gt, gidx, starts, win_w,
    # n_own, be_o, bl_o, jac, lp, r0, prec, srel, act, me0, ml0, me1, ml1, oe0,
    # ol0, oe1, ol1, mp, eta_damping, lam_damping, num_undamped, floor, jitter,
    # has_huber, huber, stream, info
    "gbp_messages_cm_tabblkg": [_I] * 5 + [_P, _I, _P, _I, _P, _P, _I, _I, _P, _P] + [_P] * 6
    + [_P] * 4 + [_P] * 4 + [_I64, _D, _D, _D, _D, _D, _I, _D, _P, _P],
    # win_w -> resident blocks per SM (negative: minus the CUDA error)
    "gbp_relin_cm_tabblk_ell_blocks_per_sm": [_I],
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
    nvcc = _nvcc()
    # Everything is written under private names in a directory of this
    # process and the library renamed into place last: a concurrent process
    # never sees a half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [str(Path(tmp) / (cu.stem + ".o")) for cu in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(cu)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cu, obj in zip(cus, objs)]
        # communicate() drains the pipes, so no compiler blocks on a full one
        # while an earlier one is waited for.
        errs = [proc.communicate()[1] for proc in procs]
        failed = [f"{cu.name} ({proc.returncode}):\n{err}"
                  for cu, proc, err in zip(cus, procs, errs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        so = str(Path(tmp) / lib.name)
        link = subprocess.run([nvcc, "-shared", "-o", so, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        (out_dir / "ptxas.txt").write_text("".join(errs))
        os.replace(so, lib)
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
