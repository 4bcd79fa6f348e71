"""The benchmark harness on the CPU, at tiny scenes: the manifest, each loop
kind and per-layer reader, the reference against the port, the faults the
check has to catch, the control, and what a run imports.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import faults, generators, run
from benchmark.generators import _geometry, simulate, simulate_blocks
from benchmark.reference import gbp, gn_map, layout

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {
    "bench64": {"scene": {"n_cams": 8, "n_lmks": 150, "pix_sigma": 1.0}},
    "venice1778": {"scene": {"n_blocks": 2, "n_cams": 10, "lmks_per_cam": 10, "window": 3,
                             "wall_dist": 4.77, "shuffle": True}},
}
TINY_TRAFFIC = {
    "steady": {"warm_sweeps": 10, "trace_chunks": 4, "group": 2},
    "solve": {"pool": 4, "warm_solves": 1, "trace_solves": 3, "check_solves": 2},
    "restart50": {"warm_sweeps": 10, "trace_chunks": 4, "restart_chunks": 2},
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(workload: str) -> dict:
    cell = next(w for w in manifest()["workloads"] if w["name"] == workload)
    return {"config": TINY[cell["config"]], "traffic": TINY_TRAFFIC[cell["traffic"]]}


def run_tiny(workload, seed=5, trace=False, faults=None):
    return run.run_cell(workload, seed, 0.3, trace, CPU, overrides=tiny(workload),
                        faults=faults)


# --- the manifest ----------------------------------------------------------------------


def test_manifest_names_units_and_references():
    man = manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    metrics = man["end_to_end"] + man["per_layer"]
    names = [e["name"] for e in man["configs"] + man["workloads"] + metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(man["end_to_end"]) <= 16 and any(m["name"] == "setup_s" for m in man["end_to_end"])
    configs = {c["name"] for c in man["configs"]}
    assert configs == {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"]: w for w in man["workloads"]}
    for w in cells:
        reported = {m for m, e in e2e.items() if w in e.get("workloads", [w])}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.cell_metrics(man, w, True), w
        assert (ROOT / "benchmark" / "limits" / f"{w}.json").is_file()
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cells[w]['traffic']}.json")
                             .read_text())
        conf = json.loads((ROOT / next(c["file"] for c in man["configs"]
                                       if c["name"] == cells[w]["config"])).read_text())
        # Found by name: the loop kind, the port and the generator.
        for kind, name in (("loops", traffic["loop"]), ("ports", conf["port"]),
                           ("generators", conf["generator"])):
            assert (ROOT / "benchmark" / kind / f"{name}.py").is_file(), (w, kind, name)
        named = {traffic[k] for k in ("rate_metric", "tail_metric") if k in traffic}
        assert named and named < reported, (w, named)
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert all(w["chips"] == 1 for w in man["workloads"])


# --- the loops and readers on the CPU ----------------------------------------------------


@pytest.mark.parametrize("workload", ["bench64.steady", "venice1778.steady", "bench64.solve"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_cpu(workload, trace):
    r = run_tiny(workload, seed=2 ** 31 + 11, trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    man = manifest()
    if trace:
        # No device operation runs on the CPU: no device metric is printed.
        device_metrics = {m["name"] for m in man["per_layer"] if m["source"] == "device_trace"}
        assert not device_metrics & set(r["metrics"])
        assert "prepare_s" in r["metrics"]
        assert r["device"]["busy_s"] == 0
        if workload.endswith("solve"):
            assert r["metrics"]["solve_sweeps"]["value"] >= 5
    else:
        assert {"setup_s"} < set(r["metrics"])
    assert r["device"]["platform"] == "cpu"


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "bench64.steady", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# --- the reference ---------------------------------------------------------------------


def test_scenes_equal_the_port_generators():
    from gbp_tpu_torch.models import ba

    for ours, theirs in (
            (simulate.generate(n_cams=6, n_lmks=80, seed=3),
             ba.simulate(n_cams=6, n_lmks=80, seed=3)),
            (simulate_blocks.generate(n_blocks=2, n_cams=8, lmks_per_cam=6, seed=4, shuffle=True,
                                      wall_dist=4.77),
             ba.simulate_blocks(n_blocks=2, n_cams=8, lmks_per_cam=6, seed=4, shuffle=True,
                                wall_dist=4.77))):
        for key in ("cam_ids", "lmk_ids"):
            np.testing.assert_array_equal(ours[key], theirs[key])
        for key in ("obs", "cam_init", "lmk_init", "cam_truth"):
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("config", ["bench64", "venice1778"])
def test_every_seed_has_the_same_sizes(config):
    conf = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    conf.update(TINY[config])
    a, b = generators.make_scene(conf, 5), generators.make_scene(conf, 2 ** 40 + 3)
    for key in ("cam_ids", "lmk_ids", "cam_truth", "lmk_truth"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["obs"].shape == b["obs"].shape and not np.array_equal(a["obs"], b["obs"])
    assert not np.array_equal(a["lmk_init"], b["lmk_init"])
    np.testing.assert_array_equal(a["cam_init"][0], a["cam_truth"][0])
    # The noise is the generator's: pixels within a few sigma of the truth.
    truth = _geometry.renoise(dict(a, pix_sigma=0.0), 1, (0, 0), 0)["obs"]
    assert np.abs(a["obs"] - truth).max() < 6 * a["pix_sigma"]


def test_layout_matches_the_port_rows():
    from gbp_tpu_torch.models import ba

    sim = simulate.generate(n_cams=6, n_lmks=80, seed=3)
    rows, n_rows, deg, slot = layout.ell_rows(sim["cam_ids"], sim["lmk_ids"], 6,
                                              sim["lmk_init"].shape[0])
    graph, _ = ba.build(sim, dtype=torch.float64, device="cpu")
    fb = graph.fblocks[0]
    assert (fb.count, fb.ell_deg, fb.ell_slot) == (n_rows, deg, slot)
    assert torch.equal(fb.adj[0][rows].long(), torch.as_tensor(sim["cam_ids"]))
    assert torch.equal(fb.adj[1][rows].long(), torch.as_tensor(sim["lmk_ids"]))
    assert bool(fb.valid[rows].all()) and int(fb.valid.sum()) == rows.size


def test_reference_equals_the_port_in_float64():
    """The reference's sweeps against the port's plain CPU path, both in
    float64, from the same start: equal to roundoff."""
    from benchmark.ports.ba_cm import Port

    sim = simulate.generate(n_cams=6, n_lmks=80, seed=3)
    config = json.loads((ROOT / "benchmark/configs/bench64.json").read_text())
    config = dict(config, dtype="float64")
    port = Port(sim, config, CPU)
    means = (port.tensor(sim["cam_init"]), port.tensor(sim["lmk_init"]))
    st = port.init(means)
    for _ in range(12):
        st = port.step(st)
    rows = torch.as_tensor(layout.ell_rows(sim["cam_ids"], sim["lmk_ids"], 6,
                                           sim["lmk_init"].shape[0])[0])
    p = port.observed(st, rows)
    pb = gbp.problem(sim, config["build"], CPU)
    ar = gbp.Arith("f64")
    sc = gbp.sweep_config(config["gbp"], "float64")
    r = gbp.run(pb, gbp.init_state(pb, means, ar), sc, ar, 12)
    from benchmark import check

    gaps = check.state_gaps(pb, p, r)
    assert max(gaps.values()) < 1e-8, gaps
    assert abs(port.are(st) - gbp.are(pb, *r.mean)) < 1e-9


def test_gauss_newton_reaches_the_port_map():
    from gbp_tpu_torch.models import ba
    from gbp_tpu_torch.parallel import schur

    sim = simulate.generate(n_cams=6, n_lmks=80, seed=3)
    pb = gbp.problem(sim, {}, CPU)
    _, _, are_ref = gn_map.gauss_newton(pb, torch.as_tensor(sim["cam_init"]),
                                        torch.as_tensor(sim["lmk_init"]))
    graph, mu = ba.build(sim, dtype=torch.float64, device="cpu")
    for _ in range(8):
        mu = schur.gauss_newton_step(graph, mu, cg_iters=200)
    assert abs(are_ref - gbp.are(pb, *mu)) < 1e-6 * are_ref


def test_map_from_an_estimate_that_overshoots():
    """Landmarks started metres off: the damped steps still reach the
    minimum that a start at the truth reaches, never raising the cost."""
    sim = simulate.generate(n_cams=6, n_lmks=80, seed=3)
    pb = gbp.problem(sim, {}, CPU)
    lmk = torch.as_tensor(sim["lmk_init"]).clone()
    lmk[:8] += 2.0 * torch.randn((8, 3), generator=torch.Generator().manual_seed(0),
                                 dtype=torch.float64)
    cam0 = torch.as_tensor(sim["cam_init"])
    c_bad, l_bad, are_bad = gn_map.gauss_newton(pb, cam0, lmk)
    c_good, l_good, are_good = gn_map.gauss_newton(pb, torch.as_tensor(sim["cam_truth"]),
                                                   torch.as_tensor(sim["lmk_truth"]))
    assert gn_map.cost(pb, c_bad, l_bad) <= gn_map.cost(pb, cam0, lmk)
    assert abs(are_bad - are_good) < 1e-6 * are_good


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.14159265], dtype=torch.float32)
    y = gbp.to_tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2.0 ** -10
    assert abs(float(y[3]) - 3.14159265) <= 2.0 ** -9


# --- the check catches the control and every fault the cells can have -----------------------


def _control(workload):
    """The control in the program's place (TF32 products), judged by the
    cell's limits: (every number within its limit, the numbers)."""
    from benchmark import check

    r = run.run_cell(workload, 9, 0.3, False, CPU, overrides=tiny(workload), control=True)
    limits = json.loads((ROOT / f"benchmark/limits/{workload}.json").read_text())
    return check.judge(r["control"], {k: v for k, v in limits.items() if k in r["control"]})


@pytest.mark.parametrize("workload", ["bench64.steady", "venice1778.steady", "bench64.solve"])
def test_control_is_not_correct(workload):
    ok, table = _control(workload)
    assert not ok, table


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", ["bench64.steady", "venice1778.steady", "bench64.solve"])
def test_faults_are_not_correct(workload, fault):
    if fault == "are_altered" and not workload.endswith("solve"):
        pytest.skip("only the solve loop reads the port's ARE")
    r = run_tiny(workload, seed=17, faults=faults.FAULTS[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["bench64.steady", "venice1778.steady", "bench64.solve"])
def test_a_step_that_never_relinearizes_disagrees_with_the_reference(workload):
    """The reference takes the program's relinearization decisions; where
    the program never takes one, relin_disagree reads the rows the reference
    would have relinearized."""
    sound = run_tiny(workload, seed=19)
    broken = run_tiny(workload, seed=19, faults=faults.never_relinearizes)
    assert sound["checks"]["relin_disagree"]["value"] <= sound["checks"]["relin_disagree"]["limit"]
    assert broken["checks"]["relin_disagree"]["value"] > broken["checks"]["relin_disagree"]["limit"]


# --- what a run imports ------------------------------------------------------------------


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from benchmark import run\n"
        "from benchmark.tests.test_bench_harness import tiny\n"
        "for w in ('bench64.steady', 'bench64.solve'):\n"
        "    run.run_cell(w, 3, 0.2, True, torch.device('cpu'), overrides=tiny(w))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                                           "HOME": str(ROOT / "benchmark" / ".cache")})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "gbp_tpu_torch" in top and "benchmark" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        src = path.read_text()
        for name in ("gbp_tpu", "jax", "flax"):
            assert not re.search(rf"^\s*(from|import)\s+{name}\b", src, re.M), (path, name)
