"""The port's online model (gbp_tpu_torch.models.online) against the JAX
reference (gbp_tpu/models/online.py), on the CPU, float64 unless stated.

The common state is the reference's own fixed-lag stream (a 14-frame
corridor through an 8-camera window, evicting 4 cameras at a time, so the
landmarks of the window's old end are re-observed and marginalized), handed
to the port through `interop.online_from_numpy`.  From it:

  helpers (frames_from_sim in both arrival modes, the SO(3) maps,
    cheirality_ok, OnlineIds over an eviction), create, snapshot: exact;
  add_frame with pad rows: counts exact, state to 1e-12 (each array
    relative to its magnitude; the residuals r0 = z - h(x), which cancel,
    relative to the measurements');
  the two annealers: 1e-12;
  evict_frames at marg_discount 0.5 and 1.0: counts and the landmark cut
    exact, state 1e-12 (the absorbed sums: the reference's segment_sum adds
    zeros for every row that keeps its camera, the port's segment sum skips
    them, so the two agree to roundoff, not bit for bit);
  run, 10 sweeps, covariance and "pallas" forms (Pallas in interpret
    mode): 1e-10 (relinearization decisions at beta are roundoff-sensitive
    over long runs; ten sweeps from one state stay well inside: the worst
    array, the landmark messages, reads 4e-11);
  the capacity guard's three ValueErrors; the device CSR against
    `adjacency_csr` of the valid rows.

The reference's own assertions of
tests/test_online.py::test_fixed_lag_eviction_streams_past_capacity run on
the port in float32: window ARE below 3 px after frame 2, the final window
within 1.5x the batch solve's ARE + 0.3 px (the batch solve through the
port's generic engine).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gbp_tpu_torch import interop
from gbp_tpu_torch.core import sweep as PS
from gbp_tpu_torch.core.graph import adjacency_csr, adjacency_csr_device
from gbp_tpu_torch.core.sweep import GBPConfig
from gbp_tpu_torch.models import ba as pba
from gbp_tpu_torch.models import online as PO

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from gbp_tpu.core.sweep import GBPConfig as JConfig
    from gbp_tpu.models import ba as jba
    from gbp_tpu.models import online as JO
except ImportError:
    jax = None

torch.set_num_threads(1)
CAP = dict(cam_capacity=8, lmk_capacity=256, obs_capacity=512, chunk=64, lmk_prior_prec=1000.0)
N_EVICT = 4
CFG = dict(eta_damping=0.4, lam_damping=0.4, num_undamped_iters=6, min_linear_iters=8)


def corridor(n_frames=14):
    return jba.simulate_corridor(n_cams=n_frames, lmks_per_cam=12, window=2, seed=1)


def frame_inputs(sim, c, live, n_lmks, chunk):
    """The reference test's per-frame inputs (numpy), updating `live`
    (global -> online landmark id) for the new landmarks."""
    k = sim["k"]
    uv_n = np.stack([(sim["obs"][:, 0] - k[2]) / k[0], (sim["obs"][:, 1] - k[3]) / k[1]], 1)
    sel = np.flatnonzero(sim["cam_ids"] == c)
    ids, new = [], []
    for t in sim["lmk_ids"][sel]:
        if t not in live:
            live[t] = n_lmks + len(new)
            new.append(sim["lmk_init"][t])
        ids.append(live[t])
    pad = lambda a: np.concatenate([a, np.zeros((chunk - len(a),) + a.shape[1:], a.dtype)])
    prec = np.full(6, 1e5 if c == 0 else 1000.0)
    return (sim["cam_init"][c], prec, np.zeros(chunk, np.int32),
            pad(np.asarray(ids, np.int32)), pad(uv_n[sel]), len(ids),
            pad(np.asarray(new, np.float64).reshape(-1, 3)), len(new))


def jax_inputs(inp):
    cam, prec, z0, ids, uv, n_o, new, n_l = inp
    return (jnp.asarray(cam), jnp.asarray(prec), jnp.asarray(z0), jnp.asarray(ids),
            jnp.asarray(uv), jnp.int32(n_o), jnp.asarray(new), jnp.int32(n_l))


_STREAMS = {}


def ref_stream(n_frames):
    """The reference's fixed-lag stream after `n_frames` frames: (sim, job,
    live id map).  Cached: the JAX steps compile once."""
    if n_frames in _STREAMS:
        sim, job, live = _STREAMS[n_frames]
        return sim, job, dict(live)
    sim = corridor()
    f = sim["k"][0]
    job = JO.create(**{k: v for k, v in CAP.items()}, pix_sigma_n=sim["pix_sigma"] / f,
                    dtype=jnp.float64)
    cfg = JConfig(**CFG)
    live = {}
    for c in range(n_frames):
        if int(job.n_cams) + 1 > CAP["cam_capacity"]:
            before = int(job.n_lmks)
            job = JO.evict_frames(job, N_EVICT)
            lmin = before - int(job.n_lmks)
            live = {g: i - lmin for g, i in live.items() if i >= lmin}
        inp = frame_inputs(sim, c, live, int(job.n_lmks), CAP["chunk"])
        job = JO.add_frame(job, *jax_inputs(inp))
        job = JO.run(job, cfg, 10)
        job = JO.weaken_landmark_priors(job, 0.6, floor=1.0)
        job = JO.weaken_camera_priors(job, 0.7, floor=30.0)
    _STREAMS[n_frames] = (sim, job, dict(live))
    return sim, job, live


def to_port(job):
    return interop.online_from_numpy(jax.tree.map(np.asarray, job), "cpu")


def ref_arrays(job) -> dict:
    """The reference's OnlineBA as a flat {name: numpy array}."""
    n = jax.tree.map(np.asarray, job)
    g, s = n.graph, n.state
    out = {}
    for i, vb in enumerate(g.vblocks):
        out[f"prior_eta{i}"], out[f"prior_lam{i}"] = vb.prior_eta, vb.prior_lam
        for k in ("eta", "lam", "mean"):
            out[f"v{i}.{k}"] = getattr(s.v[i], k)
    fb, fs = g.fblocks[0], s.f[0]
    out.update(adj0=fb.adj[0], adj1=fb.adj[1], z=fb.z, prec=fb.prec, valid=fb.valid,
               linpoint=fs.linpoint, jac=fs.jac, r0=fs.r0, me0=fs.msg_eta[0],
               me1=fs.msg_eta[1], ml0=fs.msg_lam[0], ml1=fs.msg_lam[1],
               since_relin=fs.since_relin, n_cams=n.n_cams, n_lmks=n.n_lmks, n_obs=n.n_obs,
               marg_eta=n.marg_eta, marg_lam=n.marg_lam)
    return out


def port_arrays(ob) -> dict:
    d = interop.online_to_numpy(ob)
    g, s = d["graph"], d["state"]
    out = {}
    for i, vb in enumerate(g.vblocks):
        out[f"prior_eta{i}"], out[f"prior_lam{i}"] = vb.prior_eta, vb.prior_lam
        for k in ("eta", "lam", "mean"):
            out[f"v{i}.{k}"] = s["v"][i][k]
    fb, fs = g.fblocks[0], s["f"][0]
    out.update(adj0=fb.adj[0], adj1=fb.adj[1], z=fb.z, prec=fb.prec, valid=fb.valid,
               linpoint=fs["linpoint"], jac=fs["jac"], r0=fs["r0"], me0=fs["msg_eta"][0],
               me1=fs["msg_eta"][1], ml0=fs["msg_lam"][0], ml1=fs["msg_lam"][1],
               since_relin=fs["since_relin"], n_cams=d["n_cams"], n_lmks=d["n_lmks"],
               n_obs=d["n_obs"], marg_eta=d["marg_eta"], marg_lam=d["marg_lam"])
    return out


INTS = ("adj0", "adj1", "valid", "since_relin", "n_cams", "n_lmks", "n_obs")


def hold(ob, job, tol):
    """Every array of the port's state against the reference's: integers
    and masks exact, floats to `tol` relative to each array's magnitude.
    The port's CSRs are held against `adjacency_csr` of the valid rows."""
    got, ref = port_arrays(ob), ref_arrays(job)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = np.asarray(got[k])
        r = np.asarray(r)
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if k in INTS:
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif tol == 0:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            # r0 = z - h(x) cancels: its scale is the measurements'.
            scale = max(np.abs(r).max(), np.abs(ref["z"]).max() if k == "r0" else 0.0, 1e-300)
            err = np.abs(g - r).max() / scale if r.size else 0.0
            assert err <= tol, (k, err)
    hold_csr(ob)


def hold_csr(ob):
    fb = ob.graph.fblocks[0]
    valid = fb.valid.numpy()
    for a, (rows, offs), vb in zip(fb.adj, fb.csr, ob.graph.vblocks):
        n = vb.count
        r_ref, o_ref = adjacency_csr(a.numpy()[valid], n)
        np.testing.assert_array_equal(offs.numpy(), o_ref)
        np.testing.assert_array_equal(rows.numpy()[:o_ref[-1]], np.flatnonzero(valid)[r_ref])


needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


# --- host-side helpers ------------------------------------------------------------


@needs_jax
@pytest.mark.parametrize("arrivals", ["absolute", "odometry"])
def test_frames_from_sim_exact(arrivals):
    sim = jba.simulate_corridor(n_cams=10, lmks_per_cam=12, window=2, seed=1)
    sigma = (0.02, 0.05) if arrivals == "odometry" else None
    got, ref = PO.frames_from_sim(sim, sigma), JO.frames_from_sim(sim, sigma)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if k == "rel":
                for a, b in zip(g[k], r[k]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(g[k], r[k])


@needs_jax
def test_so3_maps_and_cheirality_exact():
    rng = np.random.default_rng(0)
    for w in [*rng.normal(0, 1.0, (6, 3)), np.zeros(3), np.array([1e-13, 0, 0])]:
        np.testing.assert_array_equal(PO._so3_exp_np(w), JO._so3_exp_np(w))
        r = JO._so3_exp_np(w)
        np.testing.assert_array_equal(PO._so3_log_np(r), JO._so3_log_np(r))
    pts = rng.normal(0, 3.0, (40, 3)) + np.array([0, 0, 4.0])
    for cam in rng.normal(0, 0.8, (8, 6)):
        assert PO.cheirality_ok(cam, pts) == JO.cheirality_ok(cam, pts)
    assert PO.cheirality_ok(np.zeros(6), np.zeros((0, 3)))


@needs_jax
def test_online_ids_over_an_eviction_exact():
    got, ref = PO.OnlineIds(), JO.OnlineIds()
    frames = [np.array([5, 9, 2, 9]), np.array([9, 11, 3]), np.array([2, 40, 11])]
    n = 0
    for i, f in enumerate(frames):
        if i == 2:
            got.shift(3)
            ref.shift(3)
            n -= 3
        a, b = got.resolve(f, n), ref.resolve(f, n)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        n += len(a[1])
    assert got._map == ref._map


# --- the model --------------------------------------------------------------------


@needs_jax
def test_create_exact():
    kw = dict(cam_capacity=5, lmk_capacity=70, obs_capacity=300, chunk=32, pix_sigma_n=0.003,
              lmk_prior_prec=20.0, huber=1.5)
    ob = PO.create(**kw, dtype=torch.float64, device="cpu")
    hold(ob, JO.create(**kw, dtype=jnp.float64), 0)
    fb = ob.graph.fblocks[0]
    assert (ob.chunk, ob.lmk_prior_prec, fb.huber, fb.ftype.name) == (
        32, 20.0, 1.5, "reprojection_normalized")
    # every field its own tensor: the serving step writes them in place
    ptrs = [t.untyped_storage().data_ptr() for t in PO.tensors(ob)]
    assert len(set(ptrs)) == len(ptrs)


@needs_jax
@pytest.mark.parametrize("n_frames", [3, 9])
def test_add_frame(n_frames):
    """One more frame onto the common state (after 9 frames: one eviction
    behind it), with pad rows past the frame's observations and landmarks."""
    sim, job, live = ref_stream(n_frames)
    inp = frame_inputs(sim, n_frames, live, int(job.n_lmks), CAP["chunk"])
    assert inp[5] < CAP["chunk"] and inp[7] < CAP["chunk"]  # some pad rows
    ob = PO.add_frame(to_port(job), *inp)
    hold(ob, JO.add_frame(job, *jax_inputs(inp)), 1e-12)
    # device-tensor inputs take the same path without a read-back
    dev_inp = [torch.as_tensor(np.asarray(a)) for a in inp]
    ob2 = PO.add_frame(to_port(job), *dev_inp, check=False)
    for a, b in zip(PO.tensors(ob), PO.tensors(ob2)):
        assert torch.equal(a, b)


@needs_jax
def test_annealers():
    _, job, _ = ref_stream(9)
    ob = to_port(job)
    hold(PO.weaken_landmark_priors(ob, 0.6, floor=1.0),
         JO.weaken_landmark_priors(job, 0.6, floor=1.0), 1e-12)
    hold(PO.weaken_camera_priors(ob, 0.7, floor=30.0),
         JO.weaken_camera_priors(job, 0.7, floor=30.0), 1e-12)
    hold(PO.weaken_camera_priors(ob, 0.5, floor=1e4),
         JO.weaken_camera_priors(job, 0.5, floor=1e4), 1e-12)


@needs_jax
@pytest.mark.parametrize("marg_discount", [0.5, 1.0])
def test_evict_frames(marg_discount):
    """A full window (8 cameras, one eviction behind it): landmarks the
    evicted cameras share with the survivors stay, the others leave."""
    _, job, _ = ref_stream(12)
    assert int(job.n_cams) == CAP["cam_capacity"]
    ob = PO.evict_frames(to_port(job), N_EVICT, marg_discount)
    jev = JO.evict_frames(job, N_EVICT, marg_discount)
    lmin = int(job.n_lmks) - int(jev.n_lmks)
    assert 0 < lmin < int(job.n_lmks)
    assert int(job.n_lmks) - int(ob.n_lmks) == lmin
    hold(ob, jev, 1e-12)
    absorbed = np.abs(np.asarray(jev.marg_lam)).max()
    assert absorbed > 0


@needs_jax
@pytest.mark.parametrize("form", ["covariance", "pallas"])
def test_run(form):
    _, job, _ = ref_stream(13)
    ob = PO.run(to_port(job), GBPConfig(**CFG, message_form=form), 10)
    hold(ob, JO.run(job, JConfig(**CFG, message_form=form), 10), 1e-10)


@needs_jax
def test_snapshot_exact():
    _, job, _ = ref_stream(9)
    got, ref = PO.snapshot(to_port(job)), JO.snapshot(job)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_capacity_guard():
    ob = PO.create(cam_capacity=1, lmk_capacity=140, obs_capacity=300, chunk=128,
                   dtype=torch.float64, device="cpu")
    args = lambda n_o, n_l: (np.zeros(6), np.ones(6), np.zeros(128, np.int32),
                             np.zeros(128, np.int32), np.zeros((128, 2)), n_o,
                             np.zeros((128, 3)), n_l)
    ob = PO.add_frame(ob, *args(4, 4))
    with pytest.raises(ValueError, match="camera capacity"):
        PO.add_frame(ob, *args(4, 4))
    ob2 = PO.create(cam_capacity=4, lmk_capacity=140, obs_capacity=300, chunk=128,
                    dtype=torch.float64, device="cpu")
    ob2 = PO.add_frame(ob2, *args(100, 100))
    with pytest.raises(ValueError, match="landmark capacity"):
        PO.add_frame(ob2, *args(10, 41))
    with pytest.raises(ValueError, match="observation capacity"):
        PO.add_frame(ob2, *args(201, 10))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_csr(seed):
    rng = np.random.default_rng(seed)
    m, n = 300, 17
    adj = rng.integers(0, n, m).astype(np.int32)
    valid = rng.random(m) < (0.0 if seed == 2 else 0.6)
    rows, offs = adjacency_csr_device(torch.from_numpy(adj), torch.from_numpy(valid), n)
    assert rows.dtype == offs.dtype == torch.int32
    assert rows.shape == (m,) and offs.shape == (n + 1,)
    r_ref, o_ref = adjacency_csr(adj[valid], n)
    np.testing.assert_array_equal(offs.numpy(), o_ref)
    np.testing.assert_array_equal(rows.numpy()[:o_ref[-1]], np.flatnonzero(valid)[r_ref])
    assert sorted(rows.numpy()[o_ref[-1]:]) == sorted(np.flatnonzero(~valid))
    if valid.all():
        np.testing.assert_array_equal(rows.numpy(), adjacency_csr(adj, n)[0])


def test_fixed_lag_stream_quality_float32():
    """The reference's bounds of test_fixed_lag_eviction_streams_past_capacity
    (24 corridor frames through an 8-camera window, 10 sweeps a frame) on
    the port in float32."""
    n_frames, cap = 24, 8
    sim = pba.simulate_corridor(n_cams=n_frames, lmks_per_cam=12, window=2, seed=1)
    k = sim["k"]
    f = k[0]
    chunk = 128
    ob = PO.create(cam_capacity=cap, lmk_capacity=256, obs_capacity=1024, chunk=chunk,
                   pix_sigma_n=sim["pix_sigma"] / f, lmk_prior_prec=1000.0, device="cpu")
    cfg = GBPConfig(**CFG)
    live, ares = {}, []
    for c in range(n_frames):
        if int(ob.n_cams) + 1 > cap:
            before = int(ob.n_lmks)
            ob = PO.evict_frames(ob, N_EVICT)
            lmin = before - int(ob.n_lmks)
            live = {g: i - lmin for g, i in live.items() if i >= lmin}
        ob = PO.add_frame(ob, *frame_inputs(sim, c, live, int(ob.n_lmks), chunk))
        ob = PO.run(ob, cfg, 10)
        ob = PO.weaken_landmark_priors(ob, 0.6, floor=1.0)
        ob = PO.weaken_camera_priors(ob, 0.7, floor=30.0)
        m = ob.graph.fblocks[0].count
        ares.append(float(pba.avg_reprojection_error(ob.graph, ob.state,
                                                     px_scale=np.full((m, 2), f))))
    assert int(ob.n_cams) == cap
    assert np.isfinite(ares).all() and max(ares[2:]) < 3.0, ares

    # batch solve of the final window's subproblem
    lo = n_frames - cap
    wsel = sim["cam_ids"] >= lo
    lmk_keep = np.unique(sim["lmk_ids"][wsel])
    counts = np.bincount(sim["lmk_ids"][wsel], minlength=sim["lmk_init"].shape[0])
    lmk_keep = lmk_keep[counts[lmk_keep] >= 2]
    remap = -np.ones(sim["lmk_init"].shape[0], np.int64)
    remap[lmk_keep] = np.arange(lmk_keep.size)
    rows = wsel & (remap[sim["lmk_ids"]] >= 0)
    wsim = dict(cam_init=sim["cam_init"][lo:], lmk_init=sim["lmk_init"][lmk_keep],
                obs=sim["obs"][rows], cam_ids=sim["cam_ids"][rows] - lo,
                lmk_ids=remap[sim["lmk_ids"][rows]], k=k, pix_sigma=sim["pix_sigma"])
    graph, means = pba.build(wsim, cam_prior_prec=1000.0, lmk_prior_prec=1000.0, device="cpu")
    batch = PS.init_state(graph, means)
    for _ in range(3):
        batch = PS.run(graph, batch, cfg, 20)
        graph = pba.weaken_priors(graph, 0.1)
    batch = PS.run(graph, batch, cfg, 20)
    are_batch = float(pba.avg_reprojection_error(graph, batch, k=k))
    assert ares[-1] < 1.5 * are_batch + 0.3, (ares[-1], are_batch)


def test_tensors_and_map_tensors_round_trip():
    ob = PO.create(cam_capacity=3, lmk_capacity=20, obs_capacity=40, chunk=8, device="cpu")
    leaves = PO.tensors(ob)
    assert len(leaves) == 32  # 4 priors, 5 + 4 CSR in the fblock, 6 beliefs, 8 factor, 3 + 2
    copy = PO.map_tensors(torch.clone, ob)
    assert all(torch.equal(a, b) and a is not b for a, b in zip(leaves, PO.tensors(copy)))
    assert dataclasses.replace(copy).chunk == 8
