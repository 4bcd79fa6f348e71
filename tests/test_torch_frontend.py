"""The port's frontend (gbp_tpu_torch.frontend: features, pipeline,
init_pose; examples/sfm_from_pixels) and the rest of its Gaussian and
small-matrix helpers against the JAX reference, on the CPU.  The same numpy
inputs go through both packages; the frames are the example's scene (6
cameras, 120 landmarks, 240 x 320, seed 3), rendered once per module.

Tolerances:
  render_scene: 1e-4 absolute (measured 4.8e-5).  The two float32
    renderers place each blob centre within 7e-5 px of each other: the
    reference's compiled Rodrigues map and projection contract products into
    fused multiply-adds, torch rounds each, and a blob's slope is below 1.7
    per pixel.  A float64 projection rounded to float32 is still 2.2e-5 from
    the reference's frames: 1e-5 is below the reference's own roundoff;
  harris_response: 1e-5 of the map's maximum (the eager and the compiled
    reference differ in the last bits: the compiled one fuses multiply-adds,
    which the port repeats, so it equals the compiled map bit for bit here);
  detect: the valid corners equal as integer pixels in the reference's order
    (the checkerboard's ties included), their scores bit for bit;
  extract_patches: 1e-5 absolute; match: equal;
  build_tracks on the reference's frames: ids and pixels equal;
  triangulate, filter_tracks, essential_8pt / _ransac,
    decompose_essential, pnp_dlt / _ransac, initialize_poses: float64 to
    1e-9 relative, masks and ids exact;
  the example's ARE from the reference's frames: float64 to 1e-6 px; in
    float32 both packages' ARE against that float64 one, the port within 2x
    the reference's own float32 error;
  from_moments, isotropic, zeros, bvm: 1e-12.
"""
import numpy as np
import pytest
import torch

from gbp_tpu_torch import gaussians as PG
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.examples import sfm_from_pixels as EX
from gbp_tpu_torch.frontend import features as PF
from gbp_tpu_torch.frontend import init_pose as PI
from gbp_tpu_torch.frontend import pipeline as PP
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.utils.lie import so3_exp
from gbp_tpu_torch.utils.smalllinalg import bvm

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from gbp_tpu import gaussians as JG
    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.core.sweep import init_state as j_init_state
    from gbp_tpu.core.sweep import run as j_run
    from gbp_tpu.frontend import features as JF
    from gbp_tpu.frontend import init_pose as JI
    from gbp_tpu.frontend import pipeline as JP
    from gbp_tpu.models import ba as jba
    from gbp_tpu.utils import smalllinalg as JL
except ImportError:
    jax = None

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")
CPU = "cpu"


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300) if ref.size else 0.0


def checkerboard(h=120, w=160, step=20):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (((yy // step) + (xx // step)) % 2).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """The example's scene and both packages' frames of it."""
    sim = EX.scene()
    args = (sim["cam_truth"], sim["lmk_truth"], EX.K)
    ref = np.array(JP.render_scene(*args, shape=EX.SHAPE, seed=3))
    port = PP.render_scene(*args, shape=EX.SHAPE, seed=3, device=CPU).numpy()
    return sim, ref, port


@pytest.fixture(scope="module")
def bootstrapped(scene):
    """Both packages' tracks and pose bootstrap from the reference's frames."""
    _, frames, _ = scene
    cam_ids, lmk_ids, obs = JP.build_tracks(list(frames), **EX.TRACKING)
    cams, lmks, cam_ok, lmk_ok = JI.initialize_poses(EX.K, cam_ids, lmk_ids, obs, len(frames))
    sel = lmk_ok[lmk_ids]
    remap = -np.ones(lmk_ok.size, dtype=np.int64)
    remap[lmk_ok] = np.arange(int(lmk_ok.sum()))
    ref = dict(cam_init=cams, lmk_init=lmks[lmk_ok], obs=obs[sel], cam_ids=cam_ids[sel],
               lmk_ids=remap[lmk_ids[sel]], k=EX.K, pix_sigma=1.0)
    port, counts = EX.bootstrap(frames, CPU, log=lambda *a: None)
    return ref, port, counts, (cam_ids, lmk_ids, obs)


# --- features -------------------------------------------------------------------------


@needs_jax
def test_render_scene_matches_reference(scene):
    _, ref, port = scene
    assert port.dtype == np.float32 and port.shape == ref.shape == (6, *EX.SHAPE)
    assert np.abs(port - ref).max() <= 1e-4
    assert 0.0 <= port.min() and port.max() <= 1.0 and port.max() > 0.5


@needs_jax
def test_harris_response_matches_reference(scene):
    _, frames, _ = scene
    compiled = jax.jit(JF.harris_response)
    for img in (checkerboard(), *frames):
        got = PF.harris_response(torch.from_numpy(img)).numpy()
        for want in (np.asarray(JF.harris_response(jnp.asarray(img))),
                     np.asarray(compiled(jnp.asarray(img)))):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@needs_jax
@pytest.mark.parametrize("which,max_corners,border", [
    ("checkerboard", 64, 4), ("checkerboard", 256, 8), ("frames", 256, 8)])
def test_detect_matches_reference(scene, which, max_corners, border):
    """The checkerboard's corners come in tied pairs: the stable sort keeps
    the reference's order (the lower flat index first)."""
    images = [checkerboard()] if which == "checkerboard" else scene[1]
    for img in images:
        jxy, jscore = (np.asarray(a) for a in JF.detect(jnp.asarray(img), max_corners=max_corners,
                                                          border=border))
        xy, score = PF.detect(torch.from_numpy(img), max_corners=max_corners, border=border)
        valid = jscore > 0
        assert valid.sum() >= 20
        np.testing.assert_array_equal(score.numpy() > 0, valid)
        np.testing.assert_array_equal(xy.numpy()[valid], jxy[valid])
        np.testing.assert_array_equal(score.numpy()[valid], jscore[valid])
        if which == "checkerboard":
            assert len(set(jscore[valid].tolist())) < valid.sum()  # ties are there


@needs_jax
def test_extract_patches_matches_reference(scene):
    img = scene[1][0]
    xy, score = JF.detect(jnp.asarray(img), max_corners=128)
    xy = np.asarray(xy)[np.asarray(score) > 0]
    xy = np.concatenate([xy, xy + [0.37, -0.61], [[0.2, 0.3], [318.9, 239.5]]]).astype(np.float32)
    want = np.asarray(JF.extract_patches(jnp.asarray(img), jnp.asarray(xy)))
    got = PF.extract_patches(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    assert got.shape == want.shape == (xy.shape[0], 81)
    assert np.abs(got - want).max() <= 1e-5


@needs_jax
@pytest.mark.parametrize("gated", [False, True])
def test_match_matches_reference(scene, gated):
    """Descriptors and corners of frames 0 and 1 from the reference."""
    frames = scene[1]
    ins = []
    for img in frames[:2]:
        xy, score = JF.detect(jnp.asarray(img), max_corners=256)
        ins.append((np.array(xy), np.array(JF.extract_patches(jnp.asarray(img), xy)),
                    np.asarray(score) > 0))
    (xy1, d1, v1), (xy2, d2, v2) = ins
    kw = dict(min_score=0.9, ratio=0.85, max_disp=25.0) if gated else {}
    jm, jok = JF.match(jnp.asarray(d1), jnp.asarray(d2), valid1=jnp.asarray(v1),
                       valid2=jnp.asarray(v2), xy1=jnp.asarray(xy1), xy2=jnp.asarray(xy2), **kw)
    t = torch.from_numpy
    pm, pok = PF.match(t(d1), t(d2), valid1=t(v1), valid2=t(v2), xy1=t(xy1), xy2=t(xy2), **kw)
    assert pm.dtype == torch.int32 and pok.sum() >= 10
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


@needs_jax
def test_build_tracks_matches_reference(bootstrapped, scene):
    cam_ids, lmk_ids, obs = PP.build_tracks(list(scene[1]), device=CPU, **EX.TRACKING)
    for got, want in zip((cam_ids, lmk_ids, obs), bootstrapped[3]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert obs.shape[0] >= 100


# --- pipeline and pose bootstrap, float64 -----------------------------------------------


@needs_jax
@pytest.mark.parametrize("pix_sigma", [0.0, 1.0])
def test_triangulate_matches_reference(pix_sigma):
    sim = jba.simulate(n_cams=6, n_lmks=60, pix_sigma=pix_sigma, seed=0)
    args = (sim["cam_truth"], sim["k"], sim["cam_ids"], sim["lmk_ids"], sim["obs"])
    want = np.asarray(JP.triangulate(*args, n_lmks=60))
    got = PP.triangulate(*args, n_lmks=60, device=CPU)
    assert got.dtype == torch.float64 and rel(got, want) <= 1e-9
    if pix_sigma == 0.0:
        np.testing.assert_allclose(got.numpy(), sim["lmk_truth"], atol=1e-2)


@needs_jax
def test_filter_tracks_matches_reference(bootstrapped):
    """From the tracks of the reference's frames, with the truth's poses
    perturbed (the reference test's set-up)."""
    cam_ids, lmk_ids, obs = bootstrapped[3]
    sim = EX.scene()
    rng = np.random.default_rng(3)
    cams = sim["cam_truth"] + np.concatenate(
        [0.005 * rng.standard_normal((6, 3)), 0.02 * rng.standard_normal((6, 3))], axis=1)
    kw = dict(thresh=4.0, min_track_len=3)
    want = JP.filter_tracks(cams, EX.K, cam_ids, lmk_ids, obs, **kw)
    got = PP.filter_tracks(cams, EX.K, cam_ids, lmk_ids, obs, device=CPU, **kw)
    assert 50 <= got[2].shape[0] < obs.shape[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def two_views(n=120, outliers=0.3, seed=3):
    """The reference test's two-view correspondences with gross outliers."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)) * [2.0, 2.0, 0.8] + [0, 0, 6.0]
    r_rel = so3_exp(torch.tensor([0.05, -0.3, 0.02], dtype=torch.float64)).numpy()
    x1 = pts[:, :2] / pts[:, 2:3]
    p2 = pts @ r_rel.T + [1.0, 0.1, -0.05]
    x2 = p2[:, :2] / p2[:, 2:3]
    bad = rng.random(n) < outliers
    x2[bad] += rng.uniform(0.2, 0.8, size=(int(bad.sum()), 2))
    return x1, x2, bad


@needs_jax
def test_essential_and_decomposition_match_reference():
    x1, x2, bad = two_views()
    e_want = JI.essential_8pt(x1[~bad], x2[~bad])
    assert rel(PI.essential_8pt(x1[~bad], x2[~bad]), e_want) <= 1e-9
    e, inl = PI.essential_ransac(x1, x2, thresh=5e-3, seed=0)
    e_ref, inl_ref = JI.essential_ransac(x1, x2, thresh=5e-3, seed=0)
    np.testing.assert_array_equal(inl, inl_ref)
    assert rel(e, e_ref) <= 1e-9 and (inl & bad).sum() <= 2
    got = PI.decompose_essential(e, x1[inl], x2[inl])
    want = JI.decompose_essential(e_ref, x1[inl], x2[inl])
    for g, w in zip(got[:3], want[:3]):
        assert rel(g, w) <= 1e-9
    np.testing.assert_array_equal(got[3], want[3])


@needs_jax
def test_pnp_matches_reference():
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((40, 3)) * [2.0, 2.0, 1.0] + [0, 0, 6.0]
    r = so3_exp(torch.tensor([0.1, -0.2, 0.15], dtype=torch.float64)).numpy()
    xc = pts @ r.T + [0.3, -0.1, 0.5]
    xn = xc[:, :2] / xc[:, 2:]
    for g, w in zip(PI.pnp_dlt(xn, pts), JI.pnp_dlt(xn, pts)):
        assert rel(g, w) <= 1e-9
    xn_bad = xn.copy()
    xn_bad[::4] += rng.uniform(0.05, 0.2, size=xn_bad[::4].shape)
    got, want = PI.pnp_ransac(xn_bad, pts, seed=2), JI.pnp_ransac(xn_bad, pts, seed=2)
    np.testing.assert_array_equal(got[2], want[2])
    assert rel(got[0], want[0]) <= 1e-9 and rel(got[1], want[1]) <= 1e-9
    assert PI.pnp_dlt(xn[:5], pts[:5]) is None and JI.pnp_dlt(xn[:5], pts[:5]) is None


@needs_jax
def test_initialize_poses_with_outliers_matches_reference():
    """The reference test's 25 % gross matches: both RANSAC loops draw the
    same samples (numpy generators from the same seeds)."""
    rng = np.random.default_rng(7)
    sim = jba.simulate(n_cams=6, n_lmks=80, pix_sigma=0.3, seed=1, fov_frac=0.25)
    obs = sim["obs"].copy()
    bad = rng.random(obs.shape[0]) < 0.25
    k = sim["k"]
    obs[bad] = rng.uniform([0.0, 0.0], [2 * k[2], 2 * k[3]], size=(int(bad.sum()), 2))
    args = (k, sim["cam_ids"], sim["lmk_ids"], obs, 6)
    got, want = PI.initialize_poses(*args, device=CPU), JI.initialize_poses(*args)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[2].all() and got[3].mean() > 0.5
    assert rel(got[0], want[0]) <= 1e-9 and rel(got[1], want[1]) <= 1e-9


@needs_jax
def test_example_bootstrap_and_are_match_reference(bootstrapped):
    """The example from the reference's frames: tracks, bootstrap, then 60
    generic sweeps of `ba.build(boot, huber=2.0)`."""
    ref, port, counts, _ = bootstrapped
    assert counts["cameras"] == 6 and counts["landmarks"] == ref["lmk_init"].shape[0]
    for key in ("obs", "cam_ids", "lmk_ids"):
        np.testing.assert_array_equal(port[key], ref[key])
    for key in ("cam_init", "lmk_init"):
        assert rel(port[key], ref[key]) <= 1e-9
    jcfg = JConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8)
    runj = jax.jit(j_run, static_argnums=3)
    are = {}
    for name, jdt, pdt in (("f64", jnp.float64, torch.float64), ("f32", jnp.float32,
                                                                  torch.float32)):
        jg, jm = jba.build(ref, huber=2.0, dtype=jdt)
        jst = runj(jg, j_init_state(jg, jm), jcfg, EX.SWEEPS)
        pg, pm = pba.build(port, huber=2.0, dtype=pdt, device=CPU)
        pst = PS.run(pg, PS.init_state(pg, pm), EX.CFG, EX.SWEEPS)
        are[name] = (float(jba.avg_reprojection_error(jg, jst, k=EX.K)),
                     float(pba.avg_reprojection_error(pg, pst, k=EX.K)))
    (ref64, port64), (ref32, port32) = are["f64"], are["f32"]
    assert abs(port64 - ref64) <= 1e-6 and port64 < 1.5
    assert abs(port32 - ref64) <= 2.0 * abs(ref32 - ref64), (port32, ref32, ref64)


def test_example_runs_on_the_cpu():
    are, counts = EX.main(CPU, log=lambda *a: None)
    assert counts["cameras"] == 6 and counts["observations"] >= 100
    assert np.isfinite(are) and are < 1.5


# --- Gaussians and small matrices -------------------------------------------------------


@needs_jax
def test_gaussian_constructors_and_bvm_match_reference():
    rng = np.random.default_rng(0)
    mu = rng.standard_normal((5, 4))
    a = rng.standard_normal((5, 4, 4))
    sigma = a @ a.transpose(0, 2, 1) + 4.0 * np.eye(4)
    prec = rng.random(5) + 0.5
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    for got, want in ((PG.from_moments(t(mu), t(sigma)), JG.from_moments(mu, sigma)),
                      (PG.isotropic(t(mu), t(prec)), JG.isotropic(mu, prec)),
                      (PG.isotropic(t(mu), 3.0), JG.isotropic(mu, 3.0))):
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and rel(g, w) <= 1e-12
    z = PG.zeros((2, 3), 6, dtype=torch.float64, device=CPU)
    jz = JG.zeros((2, 3), 6, dtype=jnp.float64)
    assert z.eta.shape == jz.eta.shape and z.lam.shape == jz.lam.shape
    assert not z.eta.any() and not z.lam.any() and z.lam.device.type == "cpu"
    v = rng.standard_normal((7, 3))
    m = rng.standard_normal((7, 3, 5))
    assert rel(bvm(t(v), t(m)), JL.bvm(v, m)) <= 1e-12


# --- on the card ------------------------------------------------------------------------


@pytest.mark.cuda
def test_frontend_on_card_matches_cpu():
    """Harris, detection and triangulation on the card against the CPU:
    the map to 1e-5 of its maximum, the corners equal, and triangulate
    repeating bit for bit (no atomics in its per-landmark sum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sim = EX.scene()
    frames = PP.render_scene(sim["cam_truth"], sim["lmk_truth"], EX.K, shape=EX.SHAPE, seed=3,
                             device="cuda")
    cpu = frames.cpu()
    assert (frames.cpu() - PP.render_scene(sim["cam_truth"], sim["lmk_truth"], EX.K,
                                           shape=EX.SHAPE, seed=3, device=CPU)).abs().max() < 1e-4
    for f in range(frames.shape[0]):
        resp, want = PF.harris_response(frames[f]).cpu(), PF.harris_response(cpu[f])
        assert (resp - want).abs().max() <= 1e-5 * want.abs().max()
    args = (sim["cam_truth"], sim["k"], sim["cam_ids"], sim["lmk_ids"], sim["obs"])
    one, two = (PP.triangulate(*args, device="cuda") for _ in range(2))
    assert torch.equal(one, two)
    assert rel(one.cpu(), PP.triangulate(*args, device=CPU).numpy()) <= 1e-9
