"""Measurement-model interface for factors (counterpart of
gbp_tpu/factors/base.py).

A factor type is a small object with pure functions batched over factors:

  meas(x, args)      -> z_hat [m, zdim]
  jac(x, args)       -> J [m, zdim, tdof]  (analytic; torch has no vmapped
                                            jacfwd on the hot path)
  residual(z, z_hat) -> r [m, zdim]        (default z - z_hat; a custom
                                            `residual_fn` wraps angles or
                                            takes a manifold log)

where x [m, tdof] concatenates each factor's adjacent variable states.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class FactorType:
    """A measurement model h(x) with an analytic Jacobian.

    Attributes:
      name: label; `sweep_cm.prepare` checks it, and
        `interop.graph_from_numpy` maps the reference's types by it.
      zdim: measurement dimension.
      meas_fn: h(x, args) -> [m, zdim].
      jac_fn: J(x, args) -> [m, zdim, tdof].
      residual_fn: r(z, z_hat) -> [m, zdim]; None => z - z_hat.
      linear: True if h is affine in x (one linearization is exact).
    """

    name: str
    zdim: int
    meas_fn: Callable[[torch.Tensor, Any], torch.Tensor]
    jac_fn: Callable[[torch.Tensor, Any], torch.Tensor]
    residual_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    linear: bool = False

    def meas(self, x, args):
        return self.meas_fn(x, args)

    def jac(self, x, args):
        return self.jac_fn(x, args)

    def residual(self, z, z_hat):
        if self.residual_fn is not None:
            return self.residual_fn(z, z_hat)
        return z - z_hat
