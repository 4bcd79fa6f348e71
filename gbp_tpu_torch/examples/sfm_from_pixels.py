"""End-to-end SfM with no oracle input: pixels -> tracks -> pose bootstrap
-> GBP bundle adjustment.  The port of examples/sfm_from_pixels.py.

Renders synthetic frames (no imagery ships with the repo), tracks features
(Harris + ZNCC), bootstraps every camera pose and landmark from the 2D
tracks alone (essential matrix + incremental PnP), and refines with GBP.

    python -m gbp_tpu_torch.examples.sfm_from_pixels [--device cpu]
"""
import argparse

import numpy as np

import gbp_tpu_torch
from gbp_tpu_torch import resolve_device
from gbp_tpu_torch.core.sweep import GBPConfig, init_state, run
from gbp_tpu_torch.frontend import init_pose, pipeline
from gbp_tpu_torch.models import ba

SHAPE = (240, 320)
K = np.array([260.0, 260.0, SHAPE[1] / 2, SHAPE[0] / 2])
TRACKING = dict(max_corners=256, min_score=0.9, ratio=0.85, min_track_len=3, max_disp=25.0)
CFG = GBPConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
SWEEPS = 60


def scene():
    """The example's scene: 6 cameras, 120 landmarks, seed 3."""
    return ba.simulate(n_cams=6, n_lmks=120, seed=3, fov_frac=0.25, k=tuple(K))


def bootstrap(frames, device, log=print):
    """Tracks from the frames, then the pose bootstrap: (the bootstrapped
    problem for `ba.build`, a dict of counts)."""
    log("tracking...")
    cam_ids, lmk_ids, obs = pipeline.build_tracks(list(frames), device=device, **TRACKING)
    counts = dict(observations=int(obs.shape[0]), tracks=int(lmk_ids.max()) + 1)
    log(f"  {counts['observations']} observations across {counts['tracks']} tracks")

    log("bootstrapping poses (essential + PnP)...")
    cams, lmks, cam_ok, lmk_ok = init_pose.initialize_poses(
        K, cam_ids, lmk_ids, obs, len(frames), device=device)
    counts.update(cameras=int(cam_ok.sum()), landmarks=int(lmk_ok.sum()))
    log(f"  registered {counts['cameras']}/{len(frames)} cameras, "
        f"{counts['landmarks']} landmarks")

    sel = lmk_ok[lmk_ids]
    remap = -np.ones(lmk_ok.size, dtype=np.int64)
    remap[lmk_ok] = np.arange(int(lmk_ok.sum()))
    boot = dict(cam_init=cams, lmk_init=lmks[lmk_ok], obs=obs[sel], cam_ids=cam_ids[sel],
                lmk_ids=remap[lmk_ids[sel]], k=K, pix_sigma=1.0)
    return boot, counts


def main(device=None, log=print):
    """Run the example on `device` (None: the card); returns (final ARE in
    pixels, the counts of `bootstrap`)."""
    device = resolve_device(device)
    gbp_tpu_torch.set_exact_f32()
    sim = scene()
    log("rendering frames...")
    frames = pipeline.render_scene(sim["cam_truth"], sim["lmk_truth"], K, shape=SHAPE, seed=3,
                                   device=device)
    boot, counts = bootstrap(frames, device, log)
    graph, means = ba.build(boot, huber=2.0, device=device)

    log("refining with GBP...")
    state = run(graph, init_state(graph, means), CFG, SWEEPS)
    are = float(ba.avg_reprojection_error(graph, state, k=K))
    log(f"final avg reprojection error: {are:.3f} px")
    return are, counts


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(parser.parse_args().device)
