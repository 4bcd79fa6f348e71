"""The port's serving loop (gbp_tpu_torch.bench.serving) and online example
against the JAX reference (gbp_tpu/bench/serving.py, examples/online_slam.py).

On the CPU:
  * `_stream` over the first three frames of both arrival modes, float64,
    against the reference's `_stream` (its `step` and `step_odo`): every
    array of every frame's state to 1e-10 relative (as in
    tests/test_torch_online.py), counts exact; the odometry frames compose
    their arrival pose and landmark placement on the device;
  * the frame step (`FrameStep`, eager here) equals the library functions
    composed by hand bit for bit: its in-place write-back into the shared
    state changes nothing;
  * the reference's stationarity recipe (tests/test_online.py::
    test_serving_recipe_long_stream_stationary: 60 corridor frames, lag 12,
    4 evicted at a time, float32) with its bounds: median window ARE below
    2.5 px, the median of the last 10 below 1.25x the median + 0.5;
  * `python -m gbp_tpu_torch.examples.online_slam --device cpu` in a
    subprocess, with the reference example test's bounds.

On a card (`cuda`, skipped elsewhere): a stream whose frames are CUDA-graph
replays equals the same stream run eagerly, bit for bit, in both message
forms and both dtypes, with at most three graphs captured; a steady
captured frame makes no host synchronization.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gbp_tpu_torch.bench import serving as PSrv
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import online as PO

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from tests.test_torch_online import hold, ref_arrays

    from gbp_tpu.bench import serving as JSrv
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.models import ba as jba
    from gbp_tpu.models import online as JO

    # The reference's ARE as one compiled program (eager, it compiles each of its
    # operations apart, seconds a graph; the value agrees to roundoff).
    _jare = jax.jit(jba.avg_reprojection_error, static_argnames="fi")
except ImportError:
    jax = None

torch.set_num_threads(1)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(eta_damping=0.4, lam_damping=0.4, num_undamped_iters=0, min_linear_iters=8)
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module", autouse=True)
def _reference_caches_cleared():
    """Empty the reference's jit caches after this file, where JAX was
    imported: the reference's own tests (tests/test_online.py) count the
    compiles of `online._add_frame_jit` and `online.run` from zero."""
    yield
    if jax is not None:
        jax.clear_caches()


def stream_scene(arrivals, n_cams=60):
    """The stationarity recipe's corridor (60 cameras, 20 landmarks each)."""
    sim = pba.simulate_corridor(n_cams=n_cams, lmks_per_cam=20, window=3, seed=1)
    frames = PO.frames_from_sim(sim, (0.02, 0.05) if arrivals == "odometry" else None)
    max_obs = max(len(f["lmk_global"]) for f in frames)
    return sim, frames, int(np.ceil(max_obs / 64) * 64)


def create_kw(sim, chunk, lag):
    return dict(cam_capacity=lag, lmk_capacity=1024, obs_capacity=4096, chunk=chunk,
                pix_sigma_n=sim["pix_sigma"] / sim["k"][0], lmk_prior_prec=1000.0)


@needs_jax
@pytest.mark.parametrize("arrivals", ["absolute", "odometry"])
def test_stream_three_frames_against_reference(arrivals):
    sim, frames, chunk = stream_scene(arrivals, n_cams=12)
    frames = frames[:3]
    lag, n_evict = 12, 4
    kw = create_kw(sim, chunk, lag)
    got, ref = [], []
    PSrv._stream(PO.create(**kw, dtype=torch.float64, device="cpu"), frames, sim["lmk_init"],
                 chunk, lag, n_evict, PSrv._make_step(GBPConfig(**CFG), 10, n_evict),
                 on_frame=lambda i, ob: got.append(PO.map_tensors(torch.clone, ob)))
    JSrv._stream(JO.create(**kw, dtype=jnp.float64), frames, sim["lmk_init"], chunk,
                 JConfig(**CFG), 10, lag, n_evict, JO, jnp, JSrv._make_step(JO, jax),
                 on_frame=lambda i, ob: ref.append(ob))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        hold(g, r, 1e-10)
    if arrivals == "odometry":  # the composed arrival pose of frame 2
        assert "rel" in frames[2]
        np.testing.assert_allclose(got[2].graph.vblocks[0].prior_eta[2].numpy(),
                                   ref_arrays(ref[2])["prior_eta0"][2], rtol=1e-10)


@pytest.mark.parametrize("arrivals", ["absolute", "odometry"])
def test_frame_step_equals_the_library_functions(arrivals):
    """Frames with and without an eviction (lag 4, 7 frames) through the
    frame step and through the functions composed by hand: equal bits."""
    sim, frames, chunk = stream_scene(arrivals, n_cams=7)
    lag, n_evict = 4, 2
    cfg = GBPConfig(**CFG)
    kw = create_kw(sim, chunk, lag)
    states = []
    step = PSrv._make_step(cfg, 3, n_evict)
    ob, _ = PSrv._stream(PO.create(**kw, device="cpu"), frames, sim["lmk_init"], chunk, lag,
                         n_evict, step,
                         on_frame=lambda i, ob: states.append(PO.map_tensors(torch.clone, ob)))
    assert step.capture is False and not step.graphs
    with pytest.raises(ValueError, match="previous call"):
        step(PO.create(**kw, device="cpu"), False, False)

    def by_hand(ob, odometry, do_evict, **x):
        x = {k: torch.as_tensor(np.asarray(v)) for k, v in x.items()}
        if odometry:
            from gbp_tpu_torch.utils.lie import so3_exp, so3_log
            from gbp_tpu_torch.utils.smalllinalg import bT, bmm, bmv

            x = {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in x.items()}
            prev = ob.state.v[0].mean[int(ob.n_cams) - 1]
            r = bmm(x["rel_r"], so3_exp(prev[:3]))
            t = bmv(x["rel_r"], prev[3:]) + x["rel_t"]
            x["cam"], x["lmk"] = torch.cat([so3_log(r), t]), bmv(bT(r), x["lmk"] - t)
        if do_evict:
            ob = PO.evict_frames(ob, n_evict)
        ob = PO.add_frame(ob, x["cam"], x["prec"], x["z0"], x["oid"], x["uv"], x["n_o"],
                          x["lmk"], x["n_l"], check=False)
        ob = PO.run(ob, cfg, 3)
        ob = PO.weaken_landmark_priors(ob, 0.6, floor=1.0)
        return PO.weaken_camera_priors(ob, 0.7, floor=1000.0)

    hand = []
    PSrv._stream(PO.create(**kw, device="cpu"), frames, sim["lmk_init"], chunk, lag, n_evict,
                 by_hand, on_frame=lambda i, ob: hand.append(ob))
    assert len(hand) == len(states) == 7
    for a, b in zip(states, hand):
        for x, y in zip(PO.tensors(a), PO.tensors(b)):
            assert torch.equal(x, y)


def test_stationary_stream_float32():
    """The reference's serving recipe over 60 frames (lag 12, 4 evicted at
    a time, float32), held to the reference test's bounds."""
    sim, frames, chunk = stream_scene("absolute")
    ob = PO.create(**create_kw(sim, chunk, 12), device="cpu")
    ares = []
    step = PSrv._make_step(PSrv.CFG, 10, 4)
    PSrv._stream(ob, frames, sim["lmk_init"], chunk, 12, 4, step,
                 on_frame=lambda i, ob: ares.append(PSrv.window_are(ob, sim["k"][0])))
    a = np.asarray(ares)
    assert np.isfinite(a).all(), a
    assert np.median(a) < 2.5, np.median(a)
    assert np.median(a[-10:]) < 1.25 * np.median(a) + 0.5, (np.median(a[-10:]), np.median(a))


@needs_jax
def test_reference_serving_stream_tail(capsys):
    """The reference's serving configuration (bench/serving.py: 120 corridor
    frames, absolute arrivals, lag 16, 4 evicted at a time, 10 sweeps a
    frame, float32) on the CPU, its quality pass: the median window ARE
    stays below 2.5 px, but one hard arrival spikes the window ARE at frame
    104 (39.47 px) and the median of the last 10 frames exceeds the
    stationarity bound 1.25x the median + 0.5.  The reference's behaviour,
    not the port's (ROADMAP queue C); chip_smoke.py phase 26 holds the card's
    stream to these figures (printed here)."""
    sim = jba.simulate_corridor(n_cams=120, lmks_per_cam=40, window=3, seed=0)
    frames = JO.frames_from_sim(sim)
    chunk = int(np.ceil(max(len(f["lmk_global"]) for f in frames) / 64) * 64)
    f_px = sim["k"][0]
    ob = JO.create(cam_capacity=16, lmk_capacity=2048, obs_capacity=8192, chunk=chunk,
                   pix_sigma_n=sim["pix_sigma"] / f_px, lmk_prior_prec=1000.0)
    ares = []

    def on_frame(i, ob):
        m = ob.graph.fblocks[0].count
        ares.append(float(_jare(ob.graph, ob.state, px_scale=np.full((m, 2), f_px))))

    JSrv._stream(ob, frames, sim["lmk_init"], chunk, JConfig(**CFG), 10, 16, 4, JO, jnp,
                 JSrv._make_step(JO, jax), on_frame=on_frame)
    a = np.asarray(ares)
    med, tail = np.median(a), np.median(a[-10:])
    with capsys.disabled():
        print(f"\n[reference serving, CPU f32] 120 frames absolute: ARE median {med:.4f}, "
              f"last 10 {tail:.4f}, max {a.max():.4f} at frame {a.argmax()}, final {a[-1]:.4f} "
              f"px; bound {1.25 * med + 0.5:.4f}")
    assert np.isfinite(a).all() and med < 2.5, med
    assert a.argmax() == 104 and a.max() > 30.0, (a.argmax(), a.max())
    assert tail > 1.25 * med + 0.5, (tail, med)


def test_online_slam_example():
    # One thread in the child: under the suite's parallel workers a child that
    # spreads over every core runs tens of times slower, and gains nothing alone.
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gbp_tpu_torch.examples.online_slam", "--device", "cpu"],
        capture_output=True, text=True, timeout=420, cwd=_ROOT, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = out.stdout.splitlines()
    batch = [l for l in lines if l.startswith("final avg reprojection error")]
    assert batch and float(batch[-1].split()[4]) < 3.0, out.stdout[-2000:]
    assert "evicted" in out.stdout
    ares = [float(l.split("ARE")[1].split()[0]) for l in lines if "ARE" in l]
    assert ares and np.isfinite(ares).all() and max(ares) < 10.0, ares


# --- on the card -----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_stream(dev, dtype, form, capture, wrap=None, n_frames=24):
    sim, frames, chunk = stream_scene("absolute", n_cams=n_frames)
    step = PSrv._make_step(GBPConfig(**CFG, message_form=form), 10, 4, capture)
    ob, _ = PSrv._stream(PO.create(**create_kw(sim, chunk, 8), dtype=dtype, device=dev),
                         frames, sim["lmk_init"], chunk, 8, 4, wrap(step) if wrap else step)
    return ob, step


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["covariance", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_stream_equals_eager_on_card(dtype, form):
    dev = _card()
    captured, step = _card_stream(dev, dtype, form, True)
    eager, step_e = _card_stream(dev, dtype, form, False)
    assert 1 <= len(step.graphs) <= 3 and not step_e.graphs
    for a, b in zip(PO.tensors(captured), PO.tensors(eager)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_steady_captured_frame_makes_no_host_sync():
    """Frames 13-15 (past the first eviction, every graph captured): the
    step, staging and replay, under set_sync_debug_mode("error")."""
    dev = _card()
    strict = []

    def wrap(step):
        def call(ob, *args, **kw):
            strict.append(len(strict) >= 13)
            if not strict[-1]:
                return step(ob, *args, **kw)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(ob, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    _card_stream(dev, torch.float32, "covariance", True, wrap, n_frames=16)
    assert sum(strict) == 3
