"""Where each observation sits in the port's factor rows, worked out again
from the scene alone.

A frozen copy of the row grouping of `GraphBuilder._ell_reorder`
(`gbp_tpu_torch/core/graph.py`, commit ad6c174), which the port's
`models.ba.build(..., layout="ell")` applies: the factors are grouped by the
slot whose other slot has the fewest variables (ties: fewer rows), each
group padded to the largest degree, observation i of variable v at row
v * deg + (its rank among v's observations, in scene order).  The port's
own sort for camera windows (`sweep_cm.prepare`) is internal to its state:
`sweep_cm.to_gbp_state` returns rows and landmarks in this user order.
"""
from __future__ import annotations

import numpy as np


def ell_rows(cam_ids: np.ndarray, lmk_ids: np.ndarray, n_cams: int, n_lmks: int,
             max_pad_ratio: float = 2.0):
    """(row of each observation [m] int64, rows in all, degree, grouped
    slot: 0 cameras, 1 landmarks)."""
    m = cam_ids.shape[0]
    conns = ((np.asarray(cam_ids), n_cams), (np.asarray(lmk_ids), n_lmks))
    best = None
    for k, (idx, n) in enumerate(conns):
        deg = max(int(np.bincount(idx, minlength=n).max()), 1)
        rows = n * deg
        if rows > max_pad_ratio * m:
            continue
        key = (conns[1 - k][1], rows)
        if best is None or key < best[0]:
            best = (key, k, deg, rows)
    if best is None:
        raise ValueError("the scene has no ELL layout within the padding limit")
    _, k, deg, rows = best
    idx, n = conns[k]
    order = np.argsort(idx, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(idx, minlength=n))])
    dest = np.empty(m, dtype=np.int64)
    dest[order] = idx[order] * deg + (np.arange(m) - starts[idx[order]])
    return dest, rows, deg, k
