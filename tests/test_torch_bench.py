"""The port's benchmark layer on the CPU: the headline benchmark (`python
-m gbp_tpu_torch.bench`) against the reference's measurement, and the
harnesses (convergence, per_chip_rate, scaling, window_profile) at tiny
sizes with `--device cpu`.

Tolerances:
  headline against the reference (8 cameras, 200 landmarks, the reference's
    `sweep_cm.run` in 5-sweep chunks, Pallas in interpret mode, and its six
    Gauss-Newton steps): float64, every chunk's ARE and the MAP ARE to 1e-9
    relative (both packages run the same arithmetic; measured 1e-12);
    float32, the MAP ARE to 1e-4 relative and every chunk's ARE to 1e-3:
    the undamped first sweeps amplify float32 roundoff, and the first
    chunk's ARE differs from the reference's by 3.1e-4 relative where the
    float64 run agrees to 1e-12 (the later chunks within 1.2e-5);
  the first chunk at <= 1.05x the MAP ARE: the reference's, unless that
    chunk's ratio lies within 1e-4 of the threshold;
  per_chip_rate: one partition's ARE within 5e-3 px of plain CM's (the
    halo path's own gate: the partition sums cameras in another order);
"""
import hashlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.core import sweep_cm as J
from gbp_tpu.core.sweep import GBPConfig as JConfig
from gbp_tpu.models import ba as jba
from gbp_tpu.parallel import schur as jschur
from gbp_tpu_torch.bench import convergence, headline, per_chip_rate, scaling, window_profile
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba

torch.set_num_threads(1)
JCFG = JConfig(eta_damping=0.4, num_undamped_iters=6, min_linear_iters=8, message_form="pallas")
SCENE = dict(n_cams=8, n_lmks=200, pix_sigma=1.0, seed=0)
CHUNKS = 12
KEYS = {"metric", "value", "unit", "vs_baseline", "wall_clock_to_convergence_s", "n_factors"}
# The reference's ARE as one compiled program (eager, it compiles each of its
# operations apart, seconds a graph; the value agrees to roundoff).
_jare = jax.jit(jba.avg_reprojection_error, static_argnames="fi")


@pytest.fixture(scope="module")
def sim():
    return ba.simulate(**SCENE)


def reference(sim, jdtype):
    """The reference's ARE after each 5-sweep chunk and its MAP ARE."""
    jg, jm = jba.build(sim, dtype=jdtype)
    jc = J.prepare(jg, segsum_exact=True)
    runj = jax.jit(J.run, static_argnums=3)
    st, ares = J.init_state(jc, jm), []
    for _ in range(CHUNKS):
        st = runj(jc, st, JCFG, headline.CHUNK)
        ares.append(float(_jare(jg, J.to_gbp_state(jc, st), k=sim["k"])))
    mu = jm
    for _ in range(6):
        mu = jschur.gauss_newton_step(jg, mu, cg_iters=60)
    are_map = float(_jare(jg, jba.with_means(J.to_gbp_state(jc, st), mu), k=sim["k"]))
    return np.array(ares), are_map


def port(sim, dtype):
    graph, means = ba.build(sim, dtype=dtype, device="cpu")
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    p = headline.Problem(sim, graph, means, cmg, int(graph.fblocks[0].n_valid))
    return headline.measure(p, sweeps=10, max_chunks=CHUNKS)


@pytest.mark.parametrize("dtype, jdtype, rtol_chunk, rtol_map", [
    (torch.float64, jnp.float64, 1e-9, 1e-9),
    (torch.float32, jnp.float32, 1e-3, 1e-4),
])
def test_headline_measurement_matches_reference(sim, dtype, jdtype, rtol_chunk, rtol_map):
    r = port(sim, dtype)
    ref_ares, ref_map = reference(sim, jdtype)
    np.testing.assert_allclose(r.ares, ref_ares, rtol=rtol_chunk)
    np.testing.assert_allclose(r.are_map_px, ref_map, rtol=rtol_map)
    ratio = ref_ares / ref_map
    first = int(np.argmax(ratio <= 1.05))
    assert ratio[first] <= 1.05, "the reference does not converge within the chunks"
    if abs(ratio[first] - 1.05) > 1e-4:
        assert r.conv_sweeps == (first + 1) * headline.CHUNK
    assert r.captured_equals_eager and r.t_conv is not None and math.isfinite(r.are_px)
    assert r.n_factors == sim["obs"].shape[0]


def test_headline_prints_the_reference_keys_and_leaves_the_baseline_alone(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_N_CAMS", "8")
    monkeypatch.setenv("BENCH_N_LMKS", "200")
    before = hashlib.sha256(headline.BASELINE_CACHE.read_bytes()).hexdigest()
    result = headline.main(["--device", "cpu"])
    assert hashlib.sha256(headline.BASELINE_CACHE.read_bytes()).hexdigest() == before
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert set(result) == KEYS | {"platform"} and result["platform"] == "cpu"
    assert result["metric"] == "ba_gbp_sweeps_per_s_per_chip" and result["unit"] == "sweeps/s"
    assert result["value"] > 0 and result["vs_baseline"] > 0
    assert result["wall_clock_to_convergence_s"] is not None


def test_baseline_comes_from_the_cache_without_a_measurement():
    # sim None: a measurement would fail; the bench size's entry is cached.
    assert headline.baseline_s_per_sweep(469861, None) == pytest.approx(80.87697839736938)


@pytest.mark.parametrize("module", [headline, convergence, per_chip_rate, scaling,
                                    window_profile])
def test_every_entry_raises_without_a_card(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_convergence_runs_on_the_cpu():
    r = convergence.main(["--device", "cpu", "--n_cams", "8", "--n_lmks", "200",
                          "--max_sweeps", "40", "--chunk", "10"])
    assert set(r) == {"metric", "gbp_seconds", "gbp_sweeps", "gn_seconds_incl_compile",
                      "are_gn_px", "are_gbp_px"}
    assert r["are_gbp_px"] <= r["are_gn_px"] + 0.02 and math.isfinite(r["gbp_seconds"])


def test_per_chip_rate_one_partition_holds_plain_cm(tmp_path):
    out = tmp_path / "rate.json"
    r = per_chip_rate.main(["--device", "cpu", "--n_cams", "8", "--n_lmks", "200",
                            "--sweeps", "10", "--out", str(out)])
    assert json.loads(out.read_text()) == r
    row = r["results"]["ba"]
    assert abs(row["are_halo_cm_px"] - row["are_plain_cm_px"]) <= 5e-3
    for row in r["results"].values():
        assert row["ratio"] > 0 and row["halo_cm_kernels"] and row["plain_cm_kernels"]


@pytest.mark.parametrize("path", ["halo", "halo_cm"])
def test_scaling_columns(path):
    doc = scaling.main(["--device", "cpu", "--chips", "1", "2", "--sweeps", "2", "--reps", "1",
                        "--path", path])
    assert [row["chips"] for row in doc["results"]] == [1, 2]
    for row in doc["results"]:
        for key in ("sweeps_per_s", "raw_efficiency", "shared_silicon_efficiency",
                    "collective_overhead_efficiency", "single_process_same_size_ratio"):
            assert math.isfinite(row[key]) and row[key] > 0, (key, row)


@pytest.mark.parametrize("unfused", [False, True])
def test_window_profile_stages(unfused):
    out = window_profile.main(["--device", "cpu", "--skip_bench_scene", "--blocks", "7",
                               "--lpc", "8", "--iters", "1"] + (["--unfused"] if unfused else []))
    r = out["scenes"]["blocks280_win"]
    assert r["win_w"] > 0 and r["ell_fused"] is not unfused
    for key in ("full", "tabprep", "relin", "messages", "segsum", "folded_sum", "other"):
        assert math.isfinite(r[f"{key}_ms"]), key
    assert r["other_ms"] == pytest.approx(r["full_ms"] - r["tabprep_ms"] - r["relin_ms"]
                                          - r["messages_ms"] - r["segsum_ms"]
                                          + r["folded_sum_ms"])
