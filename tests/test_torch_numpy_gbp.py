"""The port's serial NumPy baseline (gbp_tpu_torch/bench/numpy_gbp.py)
against the reference's copy, and the port's generic engine against it per
sweep: the port's counterpart of tests/test_reference_parity.py.

Tolerances: the two NumPy copies hold the same arithmetic, so their means
are equal bit for bit.  The engine's "schur" form against the serial
implementation: 1e-4 absolute on the means each sweep, as
test_reference_parity.py holds the reference (the marginalization's own
float64 cancellation noise: precisions near 2.5e5 cancel to O(1)
cavities).
"""
import numpy as np
import pytest
import torch

from gbp_tpu.bench import numpy_gbp as J
from gbp_tpu_torch.bench import numpy_gbp as P
from gbp_tpu_torch.core.sweep import GBPConfig, init_state, sweep
from gbp_tpu_torch.models import ba

torch.set_num_threads(1)
KNOBS = dict(eta_damping=0.4, beta=0.01, min_linear_iters=8, num_undamped_iters=6)
N_CAMS = 6


@pytest.fixture(scope="module")
def sim():
    return ba.simulate(n_cams=N_CAMS, n_lmks=60, seed=0)


def _np_means(g):
    return (np.stack([v.mean for v in g.variables[:N_CAMS]]),
            np.stack([v.mean for v in g.variables[N_CAMS:]]))


def test_numpy_gbp_equals_the_reference_copy(sim):
    g_port, g_ref = P.build_ba_numpy(sim), J.build_ba_numpy(sim)
    assert len(g_port.factors) == len(g_ref.factors) == sim["obs"].shape[0]
    for it in range(12):
        g_port.synchronous_iteration(**KNOBS)
        g_ref.synchronous_iteration(**KNOBS)
        for a, b in zip(_np_means(g_port), _np_means(g_ref)):
            np.testing.assert_array_equal(a, b, err_msg=f"sweep {it}")


def test_engine_matches_numpy_gbp_per_sweep(sim):
    # numpy_gbp's prior structure: only camera 0 anchored.
    graph, means = ba.build(sim, anchor_prec=(1e5, 1.0), cam_prior_prec=1.0,
                            lmk_prior_prec=1.0, dtype=torch.float64, layout="none",
                            device="cpu")
    state = init_state(graph, means)
    cfg = GBPConfig(message_form="schur", **KNOBS)
    g_np = P.build_ba_numpy(sim)
    for it in range(12):
        g_np.synchronous_iteration(**KNOBS)
        state = sweep(graph, state, cfg)
        cams, lmks = _np_means(g_np)
        np.testing.assert_allclose(state.v[0].mean.numpy(), cams, atol=1e-4,
                                   err_msg=f"camera means diverged at sweep {it}")
        np.testing.assert_allclose(state.v[1].mean.numpy(), lmks, atol=1e-4,
                                   err_msg=f"landmark means diverged at sweep {it}")
