"""The port's small linear algebra and SO(3) helpers against the JAX
reference (gbp_tpu.utils / gbp_tpu.ops.comp_linalg), in float64.

Tolerance 1e-12 relative: the port runs the same closed forms and the same
Schur recursion in the same order, so only roundoff of the few operations
whose order the two frameworks choose themselves (the reductions inside
bmm/bmv) separates them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_tpu.ops import comp_linalg as jcl
from gbp_tpu.utils import lie as jlie
from gbp_tpu.utils import smalllinalg as jsl
from gbp_tpu_torch.ops import comp_linalg as pcl
from gbp_tpu_torch.utils import lie as plie
from gbp_tpu_torch.utils import smalllinalg as psl

torch.set_num_threads(1)
TOL = 1e-12


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def random_spd(rng, batch, d):
    a = rng.standard_normal((batch, d, d))
    # Spread the diagonal over decades, as GBP cavities do.
    scale = 10.0 ** rng.uniform(-2, 3, (batch, d))
    spd = a @ a.transpose(0, 2, 1) + d * np.eye(d)
    return spd * np.sqrt(scale[:, :, None] * scale[:, None, :])


@pytest.mark.parametrize("fn", ["sym_inv", "scaled_sym_inv", "scaled_sym_solve"])
@pytest.mark.parametrize("d", [1, 2, 3, 6, 9])
def test_smalllinalg_matches_reference(fn, d):
    rng = np.random.default_rng(d)
    a = random_spd(rng, 64, d)
    b = rng.standard_normal((64, d))
    if fn == "scaled_sym_solve":
        ref = jsl.scaled_sym_solve(jnp.asarray(a), jnp.asarray(b))
        got = psl.scaled_sym_solve(torch.from_numpy(a), torch.from_numpy(b))
    else:
        ref = getattr(jsl, fn)(jnp.asarray(a), d)
        got = getattr(psl, fn)(torch.from_numpy(a), d)
    assert rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_component_inverse_matches_reference(d):
    """The component-form (kernel plain version) inverse, `cscaled_sym_inv`
    and through it `csym_inv`, against the reference's component form."""
    rng = np.random.default_rng(10 + d)
    a = random_spd(rng, 256, d)
    ref = jcl.cscaled_sym_inv([[jnp.asarray(a[:, i, j]) for j in range(d)] for i in range(d)])
    got = pcl.cscaled_sym_inv([[torch.from_numpy(a[:, i, j]) for j in range(d)]
                               for i in range(d)])
    for i in range(d):
        for j in range(d):
            assert rel(got[i][j].numpy(), ref[i][j]) <= TOL
    # And it is the inverse.
    inv = np.stack([np.stack([got[i][j].numpy() for j in range(d)], -1) for i in range(d)], -2)
    np.testing.assert_allclose(inv @ a, np.broadcast_to(np.eye(d), a.shape), atol=1e-9)


def _axis_angles(regime, rng, n=64):
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    theta = {
        "near_zero": 10.0 ** rng.uniform(-9, -3, n),
        "near_pi": np.pi - 10.0 ** rng.uniform(-7, -2, n),
        "generic": rng.uniform(0.1, 3.0, n),
    }[regime]
    return axes * theta[:, None]


@pytest.mark.parametrize("regime", ["near_zero", "near_pi", "generic"])
def test_so3_exp_log_match_reference(regime):
    w = _axis_angles(regime, np.random.default_rng(3))
    r_ref = jlie.so3_exp(jnp.asarray(w))
    r_got = plie.so3_exp(torch.from_numpy(w))
    assert rel(r_got.numpy(), r_ref) <= TOL
    rot = np.array(r_ref)
    w_ref = jlie.so3_log(jnp.asarray(rot))
    w_got = plie.so3_log(torch.from_numpy(rot))
    assert rel(w_got.numpy(), w_ref) <= TOL
    assert rel(plie.hat3(torch.from_numpy(w)).numpy(), jlie.hat3(jnp.asarray(w))) == 0.0


def test_set_exact_f32_pins_full_precision():
    import gbp_tpu_torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        gbp_tpu_torch.set_exact_f32()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
