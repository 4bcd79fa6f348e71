"""ctypes loader for the port's native parsers (io/native/*.cpp).

Each parser is compiled with g++ on first use into the package's own
gitignored build directory, gbp_tpu_torch/_build/native/<hash of the
source>/, and loaded from there.  Where no compiler is present (or the
build fails) the loaders return None and io/bal.py and io/g2o.py parse in
pure Python, as the reference's host parsers do: the same arrays, slower.
Nothing here touches a device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD = _HERE.parent / "_build" / "native"
_libs: dict = {}


def _build(src: Path) -> Path | None:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out_dir = _BUILD / tag
    so = out_dir / f"{src.stem}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{src.stem}.tmp{os.getpid()}.so"
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _get(src_name: str):
    """Build and load a native parser library, or None (pure-Python parse)."""
    if src_name in _libs:
        return _libs[src_name]
    _libs[src_name] = None
    so = _build(_HERE / "native" / src_name)
    if so is not None:
        try:
            _libs[src_name] = ctypes.CDLL(str(so))
        except OSError:
            pass
    return _libs[src_name]


def get_lib():
    """The BAL parser library, or None."""
    lib = _get("fastbal.cpp")
    if lib is not None:
        lib.bal_header.restype = ctypes.c_int
        lib.bal_parse.restype = ctypes.c_int
    return lib


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_bal_bytes(data: bytes):
    """Parse a BAL text buffer natively; returns the `read_bal` dict, or
    None without a native parser.  Raises ValueError for a malformed file."""
    lib = get_lib()
    if lib is None:
        return None
    n_cams, n_points, n_obs = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.bal_header(data, ctypes.c_int64(len(data)), ctypes.byref(n_cams),
                        ctypes.byref(n_points), ctypes.byref(n_obs))
    if rc != 0:
        raise ValueError("invalid BAL header")
    nc, npt, no = n_cams.value, n_points.value, n_obs.value
    cam_ids = np.empty(no, dtype=np.int64)
    point_ids = np.empty(no, dtype=np.int64)
    obs = np.empty((no, 2), dtype=np.float64)
    cam_params = np.empty((nc, 9), dtype=np.float64)
    points = np.empty((npt, 3), dtype=np.float64)
    rc = lib.bal_parse(data, ctypes.c_int64(len(data)), _i64p(cam_ids), _i64p(point_ids),
                       _f64p(obs), _f64p(cam_params), _f64p(points))
    if rc == 1:
        raise ValueError("truncated/garbled BAL file")
    if rc == 2:
        raise ValueError("trailing tokens in BAL file")
    return dict(cam_params=cam_params, points=points, obs=obs, cam_ids=cam_ids,
                point_ids=point_ids)


def parse_g2o_bytes(data: bytes):
    """Parse a g2o text buffer natively into raw row arrays, or None without
    a native parser: dict(v2_id, v2 [n, 3], e2_ij [m, 2], e2 [m, 9], v3_id,
    v3 [n, 7], e3_ij [m, 2], e3 [m, 28]).  Quaternions and the information
    frame are the caller's (vectorized) job."""
    lib = _get("fastg2o.cpp")
    if lib is None:
        return None
    lib.g2o_count.restype = ctypes.c_int
    lib.g2o_parse.restype = ctypes.c_int
    counts = np.zeros(4, dtype=np.int64)
    if lib.g2o_count(data, ctypes.c_int64(len(data)), _i64p(counts)) != 0:
        raise ValueError("g2o count pass failed")
    nv2, ne2, nv3, ne3 = (int(x) for x in counts)
    v2_id = np.empty(nv2, dtype=np.int64)
    v2 = np.empty((nv2, 3), dtype=np.float64)
    e2_ij = np.empty((ne2, 2), dtype=np.int64)
    e2 = np.empty((ne2, 9), dtype=np.float64)
    v3_id = np.empty(nv3, dtype=np.int64)
    v3 = np.empty((nv3, 7), dtype=np.float64)
    e3_ij = np.empty((ne3, 2), dtype=np.int64)
    e3 = np.empty((ne3, 28), dtype=np.float64)
    rc = lib.g2o_parse(data, ctypes.c_int64(len(data)), _i64p(v2_id), _f64p(v2), _i64p(e2_ij),
                       _f64p(e2), _i64p(v3_id), _f64p(v3), _i64p(e3_ij), _f64p(e3))
    if rc != 0:
        raise ValueError("malformed g2o line")
    return dict(v2_id=v2_id, v2=v2, e2_ij=e2_ij, e2=e2, v3_id=v3_id, v3=v3, e3_ij=e3_ij, e3=e3)
