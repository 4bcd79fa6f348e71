"""Independent corridors merged into one scene.

A frozen copy of `simulate_blocks` in `gbp_tpu_torch/models/ba.py` at commit
ad6c174, with the same `numpy.random.Generator` call order; found by the
name a configuration gives as its "generator".
"""
from __future__ import annotations

import numpy as np

from benchmark.generators import simulate_corridor
from benchmark.generators._geometry import renoise  # noqa: F401


def generate(n_blocks=8, n_cams=40, lmks_per_cam=20, window=3, seed=0, shuffle=False,
                    **kw):
    """`n_blocks` independent corridors (seeds seed, seed + 1, ...) merged into
    one scene; shuffle=True numbers the landmarks at random over the whole
    scene (seed + 99)."""
    sims = [simulate_corridor.generate(n_cams=n_cams, lmks_per_cam=lmks_per_cam, window=window,
                              seed=seed + i, **kw) for i in range(n_blocks)]
    out = {key: np.concatenate([s[key] for s in sims])
           for key in ("cam_truth", "cam_init", "lmk_truth", "lmk_init", "obs")}
    cam_off = np.cumsum([0] + [s["cam_init"].shape[0] for s in sims])
    lmk_off = np.cumsum([0] + [s["lmk_init"].shape[0] for s in sims])
    out["cam_ids"] = np.concatenate([s["cam_ids"] + o for s, o in zip(sims, cam_off)])
    out["lmk_ids"] = np.concatenate([s["lmk_ids"] + o for s, o in zip(sims, lmk_off)])
    out["k"], out["pix_sigma"] = sims[0]["k"], sims[0]["pix_sigma"]
    if shuffle:
        perm = np.random.default_rng(seed + 99).permutation(lmk_off[-1])
        out["lmk_truth"], out["lmk_init"] = out["lmk_truth"][perm], out["lmk_init"][perm]
        out["lmk_ids"] = np.argsort(perm)[out["lmk_ids"]]
    return out
