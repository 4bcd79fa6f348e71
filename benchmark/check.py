"""The numbers that decide `correct`: the program's state against the
reference's, after the same sweeps from the same start.

Every gap is relative, taken row by row (or variable by variable) and then
the widest over the scene, or, where the traffic gives "gap_quantile" q,
the row gaps' q-quantile (the widest of all but the last 1 - q share):

  relin_gap   the relinearization's outputs (linearization point,
              Jacobian, residual, sweeps since the last relinearization),
              |program - reference| / max(|reference row|, median row);
  msg_gap     the factor-to-variable messages of both slots (eta | lam),
              as relin_gap;
  sum_gap     each variable's sum of incoming messages (the camera side as
              kernels 2 and 10 fold it; the landmark side), read from the
              program's beliefs less the priors, as relin_gap;
  belief_gap  the belief means' gap in standard deviations,
              sqrt(d^T Lam d) with the reference's precision Lam.

The loops add relin_disagree (the share of eligible rows at which the
reference's own relinearization decision differs from the program's, which
it takes: `loops/_common.chunk_check`) and the solve's are_gap, stop_gap
and rerun_gap.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.gbp import Problem, State


def _rel_rows(p: torch.Tensor, r: torch.Tensor, q: float | None = None) -> float:
    """max (or the q-quantile) over rows of |p - r| / max(|r|, median |r|),
    rows flattened."""
    p, r = p.reshape(p.shape[0], -1).double(), r.reshape(r.shape[0], -1).double()
    norm = torch.linalg.vector_norm(r, dim=1)
    floor = torch.clamp(norm.median(), min=torch.finfo(torch.float64).tiny)
    gap = (torch.linalg.vector_norm(p - r, dim=1) / torch.maximum(norm, floor)).nan_to_num(
        nan=float("inf"))
    if q is None:
        return float(gap.max())
    return float(gap.kthvalue(max(1, math.ceil(q * gap.numel()))).values)


def state_gaps(pb: Problem, p: State, r: State, q: float | None = None) -> dict:
    """{relin_gap, msg_gap, sum_gap, belief_gap} of program state `p`
    against reference state `r` (both in observation order); `q` takes the
    row gaps' quantile in place of their widest (belief_gap stays the
    widest)."""
    relin = torch.cat([p.lp, p.jac.flatten(1), p.r0, p.srel[:, None]], 1)
    relin_r = torch.cat([r.lp, r.jac.flatten(1), r.r0, r.srel[:, None]], 1)
    msg = max(_rel_rows(torch.cat([p.msg_eta[s], p.msg_lam[s].flatten(1)], 1),
                        torch.cat([r.msg_eta[s], r.msg_lam[s].flatten(1)], 1), q)
              for s in range(2))
    sums = []
    for s, prior in enumerate((pb.cam_prior, pb.lmk_prior)):
        pe, pl = p.eta[s] - prior[0], p.lam[s] - prior[1]
        re, rl = r.eta[s] - prior[0], r.lam[s] - prior[1]
        sums.append(_rel_rows(torch.cat([pe, pl.flatten(1)], 1),
                              torch.cat([re, rl.flatten(1)], 1), q))
    belief = 0.0
    for s in range(2):
        d = (p.mean[s] - r.mean[s]).double()
        m2 = (d * torch.matmul(r.lam[s].double(), d[..., None])[..., 0]).sum(-1)
        belief = max(belief, float(torch.sqrt(torch.clamp(m2, min=0.0)).max()
                                   .nan_to_num(nan=float("inf"))))
    return dict(relin_gap=_rel_rows(relin, relin_r, q), msg_gap=msg, sum_gap=max(sums),
                belief_gap=belief)


def worst(*readings: dict) -> dict:
    """Each number's widest reading over several comparisons."""
    out = {}
    for rd in readings:
        for k, v in rd.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(every number within its limit, {name: {"value", "limit"}}).  A
    number without a limit, or a limit without its number, fails."""
    finite = lambda v: v if v is not None and math.isfinite(v) else None
    table = {k: {"value": finite(numbers.get(k)), "limit": limits.get(k)}
             for k in sorted(set(numbers) | set(limits))}
    ok = all(e["value"] is not None and e["limit"] is not None and e["value"] <= e["limit"]
             for e in table.values())
    return ok, table
