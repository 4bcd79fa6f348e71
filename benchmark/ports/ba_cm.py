"""The system under test: the port's bundle-adjustment path, driven through
its public entry points and nothing else.

    models.ba.build -> core.sweep_cm.prepare -> core.sweep_cm.init_state ->
    core.sweep_cm.sweep (n sweeps captured as one CUDA graph by
    utils.capture.CapturedRun) -> models.ba.avg_reprojection_error on
    core.sweep_cm.to_gbp_state

The benchmark hands it the scene and reads back its state in user order
(`to_gbp_state`); where each observation sits in those rows the reference
works out itself (`reference/layout.py`).  Configurations name it "ba_cm".
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.device import sync
from benchmark.reference.gbp import State

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Port:
    """The port prepared for one configuration's scene on `device`."""

    def __init__(self, sim: dict, config: dict, device: torch.device):
        import gbp_tpu_torch
        from gbp_tpu_torch.core import sweep_cm
        from gbp_tpu_torch.core.sweep import GBPConfig
        from gbp_tpu_torch.models import ba

        gbp_tpu_torch.set_exact_f32()
        self._sweep_cm, self._ba = sweep_cm, ba
        self.device = device
        self.k = np.asarray(sim["k"], dtype=np.float64)
        self.dtype = DTYPES[config["dtype"]]
        t0 = time.perf_counter()
        self.graph, self.means = ba.build(sim, dtype=self.dtype, device=device, **config["build"])
        self.cmg = sweep_cm.prepare(self.graph, **config["prepare"])
        sync(device)
        self.prepare_s = time.perf_counter() - t0
        if self.cmg is None:
            raise RuntimeError("the configuration's graph must take the port's fast path")
        self.cfg = GBPConfig(**config["gbp"])

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(self.device, self.dtype)

    def init(self, means: tuple):
        """`sweep_cm.init_state` at (camera, landmark) means, device tensors
        in user order."""
        return self._sweep_cm.init_state(self.cmg, means)

    def step(self, state):
        return self._sweep_cm.sweep(self.cmg, state, self.cfg)

    def are(self, state) -> float:
        """The port's ARE in pixels of a state (a host read: it syncs)."""
        return float(self._ba.avg_reprojection_error(
            self.graph, self._sweep_cm.to_gbp_state(self.cmg, state), k=self.k))

    def observed(self, state, rows: torch.Tensor) -> State:
        """The state in observation order (`rows`: each observation's row
        in user order), float64, on the device."""
        gs = self._sweep_cm.to_gbp_state(self.cmg, state)
        f = gs.f[0]
        d = lambda t: t[rows].double()
        return State(lp=d(f.linpoint), jac=d(f.jac), r0=d(f.r0), srel=d(f.since_relin),
                     msg_eta=tuple(d(t) for t in f.msg_eta),
                     msg_lam=tuple(d(t) for t in f.msg_lam),
                     eta=tuple(v.eta.double() for v in gs.v),
                     lam=tuple(v.lam.double() for v in gs.v),
                     mean=tuple(v.mean.double() for v in gs.v))

    def close(self) -> None:
        """Drop the prepared graph (the reference runs after the program's
        state is freed)."""
        self.graph = self.cmg = self.means = None
