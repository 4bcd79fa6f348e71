"""BAL (Bundle Adjustment in the Large) file IO: counterpart of
gbp_tpu/io/bal.py.

Format (https://grail.cs.washington.edu/projects/bal/):

    n_cams n_points n_obs
    cam_idx point_idx u v          # x n_obs
    <camera params, 9 per camera>  # R (Rodrigues, 3), t (3), f, k1, k2
    <point coords, 3 per point>

The BAL camera projects P = R X + t, p = -P / P.z (note the negation),
pixel = f * (1 + k1 r^2 + k2 r^4) * p, the principal point at the origin.
`to_sim` turns a parsed problem into the dict `models.ba.build_bal` takes.
"""
from __future__ import annotations

import gzip

import numpy as np

from gbp_tpu_torch.io import _native


def read_bal(path, native: bool = True):
    """Parse a BAL file (optionally .gz) -> dict of numpy arrays:
    cam_params [n_cams, 9] float64 (omega, t, f, k1, k2), points
    [n_points, 3], obs [n_obs, 2] pixels (BAL origin-centred), cam_ids and
    point_ids [n_obs] int64.

    native=True parses with the port's C++ tokenizer (io/native/fastbal.cpp,
    built with g++ on first use); without a compiler, or where the native
    parse rejects a token, it falls back to the pure-Python tokenizer, which
    gives the same arrays (and raises its own error for a malformed file).
    The parse runs on the host."""
    opener = gzip.open if str(path).endswith(".gz") else open
    if native:
        with opener(path, "rb") as f:
            data = f.read()
        try:
            out = _native.parse_bal_bytes(data)
        except ValueError:
            out = None
        if out is not None:
            return out
        tokens = data.decode().split()
    else:
        with opener(path, "rt") as f:
            tokens = f.read().split()
    it = iter(tokens)

    def take(n):
        return np.array([float(next(it)) for _ in range(n)])

    n_cams, n_points, n_obs = (int(next(it)) for _ in range(3))
    cam_ids = np.empty(n_obs, dtype=np.int64)
    point_ids = np.empty(n_obs, dtype=np.int64)
    obs = np.empty((n_obs, 2))
    for i in range(n_obs):
        cam_ids[i] = int(float(next(it)))
        point_ids[i] = int(float(next(it)))
        obs[i, 0] = float(next(it))
        obs[i, 1] = float(next(it))
    cam_params = take(9 * n_cams).reshape(n_cams, 9)
    points = take(3 * n_points).reshape(n_points, 3)
    rest = list(it)
    if rest:
        raise ValueError(f"trailing tokens in BAL file {path!r}: {len(rest)}")
    return dict(cam_params=cam_params, points=points, obs=obs, cam_ids=cam_ids,
                point_ids=point_ids)


def write_bal(path, cam_params, points, obs, cam_ids, point_ids):
    """Write a BAL-format file (inverse of read_bal; .gz compresses)."""
    cam_params = np.asarray(cam_params, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    obs = np.asarray(obs, dtype=np.float64)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(f"{cam_params.shape[0]} {points.shape[0]} {obs.shape[0]}\n")
        for c, p, (u, v) in zip(cam_ids, point_ids, obs):
            f.write(f"{int(c)} {int(p)} {u:.12g} {v:.12g}\n")
        for cam in cam_params:
            f.write("\n".join(f"{x:.17g}" for x in cam) + "\n")
        for pt in points:
            f.write("\n".join(f"{x:.17g}" for x in pt) + "\n")


def to_sim(bal: dict, pix_sigma: float = 1.0) -> dict:
    """A parsed BAL problem as the `sim` dict of `models.ba.build_bal`: the
    pose part of each camera as cam_init, the per-camera intrinsics [f, k1,
    k2] kept beside it.  BAL files carry only the initial estimate, which
    also stands in for the truth."""
    cp = bal["cam_params"]
    return dict(
        cam_init=cp[:, :6].copy(),
        cam_truth=cp[:, :6].copy(),
        lmk_init=bal["points"].copy(),
        lmk_truth=bal["points"].copy(),
        obs=bal["obs"].copy(),
        cam_ids=bal["cam_ids"].copy(),
        lmk_ids=bal["point_ids"].copy(),
        intrinsics=cp[:, 6:9].copy(),
        pix_sigma=pix_sigma,
    )


def prune(bal: dict, min_track_len: int = 2) -> dict:
    """Drop landmarks observed fewer than min_track_len times and remap ids."""
    n_points = bal["points"].shape[0]
    counts = np.bincount(bal["point_ids"], minlength=n_points)
    keep = counts >= min_track_len
    remap = -np.ones(n_points, dtype=np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    sel = keep[bal["point_ids"]]
    return dict(
        cam_params=bal["cam_params"],
        points=bal["points"][keep],
        obs=bal["obs"][sel],
        cam_ids=bal["cam_ids"][sel],
        point_ids=remap[bal["point_ids"][sel]],
    )
