"""Measurement-model interface for factors (counterpart of
gbp_tpu/factors/base.py).

A factor type is a small object with pure functions batched over factors:

  meas(x, args)      -> z_hat [m, zdim]
  jac(x, args)       -> J [m, zdim, tdof]  (analytic; torch has no vmapped
                                            jacfwd on the hot path)
  residual(z, z_hat) -> r [m, zdim]        (z - z_hat; custom residuals
                                            such as angle wraps follow with
                                            the pose-graph factors, ROADMAP A8)

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
    """

    name: str
    zdim: int
    meas_fn: Callable[[torch.Tensor, Any], torch.Tensor]
    jac_fn: Callable[[torch.Tensor, Any], torch.Tensor]

    def meas(self, x, args):
        return self.meas_fn(x, args)

    def jac(self, x, args):
        return self.jac_fn(x, args)

    def residual(self, z, z_hat):
        return z - z_hat
