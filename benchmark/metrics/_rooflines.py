"""The two HBM rooflines, from the scene's shapes alone (never the
port's tensors), so that they read the same work whatever a change to
the program does to implement it.

messages_roofline: percent of the HBM roofline that the messages step
reaches: the bytes the step needs, over the card's peak bandwidth,
over the device time a sweep of the kernels that do it (the messages
kernels and the camera-side sum: names starting `gbp::messages`,
`gbp::segsum` or `gbp::scatter_win`).

Bytes the step needs a sweep, from the scene's shapes alone (each byte read
once and written once; symmetric matrices at their d(d+1)/2 values):
  per observation, read  Jacobian z*t, linearization point t, residual z,
                         measurement precision z, sweeps since relin 1,
                         old messages of both slots (d_c + sym(d_c) + d_l + sym(d_l));
                 write   new messages of both slots (d_c + sym(d_c) + d_l + sym(d_l));
  per camera,    read    its belief (d_c + sym(d_c)); write its message sum (the same);
  per landmark,  read    its belief (d_l + sym(d_l)).

sweep_roofline: percent of the HBM roofline that a whole sweep reaches: the bytes a sweep needs, over the card's peak bandwidth, over the
traced window's time a sweep (window / sweeps, idle time included).

Bytes a sweep needs, from the scene's shapes and, for the masked
relinearization, the rows the reference relinearizes a sweep on these
inputs (each byte read once and written once; symmetric matrices at
d(d+1)/2 values; t = d_c + d_l):
  per observation, read  linearization point t, sweeps since relin 1,
                         Jacobian z*t, residual z, precision z, old
                         messages (d_c + sym(d_c) + d_l + sym(d_l));
                 write   sweeps since relin 1, new messages (as read);
  per relinearized row,  read the measurement z; write t + z*t + z;
  per variable (d),      read its diagonal prior 2d and its belief mean d;
                         write its belief: d + sym(d) + d.
"""
from __future__ import annotations

from benchmark.metrics._common import has_device, sym

KERNELS = ("gbp::messages", "gbp::segsum", "gbp::scatter_win")


def step_bytes(s: dict) -> int:
    dc, dl, z = s["cam_dof"], s["lmk_dof"], s["zdim"]
    t = dc + dl
    msgs = dc + sym(dc) + dl + sym(dl)
    per_obs = z * t + t + z + z + 1 + msgs + msgs
    per_cam = 2 * (dc + sym(dc))
    per_lmk = dl + sym(dl)
    return s["itemsize"] * (s["n_obs"] * per_obs + s["n_cams"] * per_cam
                            + s["n_lmks"] * per_lmk)


def messages_roofline(r):
    if not has_device(r) or r.peaks is None:
        return None
    sec = r.trace.device_s(lambda name: any(k in name for k in KERNELS)) / r.sweeps
    if sec <= 0:
        return None
    return 100.0 * step_bytes(r.counters["shapes"]) / r.peaks["hbm_bytes_per_s"] / sec



def sweep_bytes(s: dict, relin_rows: float) -> float:
    dc, dl, z = s["cam_dof"], s["lmk_dof"], s["zdim"]
    t = dc + dl
    msgs = dc + sym(dc) + dl + sym(dl)
    per_obs = (t + 1 + z * t + z + z + msgs) + (1 + msgs)
    per_relin = z + (t + z * t + z)
    per_var = lambda d: 2 * d + d + (d + sym(d) + d)
    return s["itemsize"] * (s["n_obs"] * per_obs + relin_rows * per_relin
                            + s["n_cams"] * per_var(dc) + s["n_lmks"] * per_var(dl))


def sweep_roofline(r):
    if not has_device(r) or r.peaks is None:
        return None
    sec = r.trace.window_s / r.sweeps
    b = sweep_bytes(r.counters["shapes"], r.counters["relin_rows_per_sweep"])
    return 100.0 * b / r.peaks["hbm_bytes_per_s"] / sec
