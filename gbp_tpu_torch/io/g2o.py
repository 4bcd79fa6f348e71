"""g2o pose-graph file IO (VERTEX_SE2/EDGE_SE2, VERTEX_SE3:QUAT/EDGE_SE3:QUAT).

Counterpart of gbp_tpu/io/g2o.py: the standard benchmark format (M3500,
intel, sphere2500, ...) for the pose-graph model.  `read_g2o` parses with
the port's native tokenizer (io/native/fastg2o.cpp, built with g++ on first
use) and converts its raw rows vectorized; without a compiler it reads line
by line in Python, with the same output.  Rotations go through the port's
`utils.lie` on the CPU in float64.

SE2 lines:
    VERTEX_SE2 id x y theta
    EDGE_SE2 i j dx dy dtheta  i11 i12 i13 i22 i23 i33   (upper-tri information)
SE3 lines:
    VERTEX_SE3:QUAT id x y z qx qy qz qw
    EDGE_SE3:QUAT i j dx dy dz qx qy qz qw  <21 upper-tri information entries>

Information-matrix convention
-----------------------------
g2o defines an edge's information matrix w.r.t. its own error vector
e_g2o = vec(Z^-1 · X_i^-1 X_j): the translation error is expressed in the
MEASUREMENT frame (t_err = R_z^T (h_t - z_t)).  Our factors
(factors/odometry.py, factors/se3.py) use the residual
e_ours = [z_t - h_t (frame i), log(R_h^T R_z)] whose translation block lives
in frame i.  Exactly (not just to first order), e_g2o = -blockdiag(R_z^T, I)
e_ours, so the information for our residual is the congruence

    Lam_ours = A · Lam_g2o · A^T,     A = blockdiag(R_z, I)

which this reader applies on load (and the writers invert).  For isotropic
translation info the transform is the identity — anisotropic translation
info is where skipping it silently mis-weights edges.  Rotation block: our
log residual and g2o's quaternion-vector error agree to first order up to a
global scale (q_vec ≈ ω/2); like gtsam/ceres we adopt the log convention
verbatim, which matches how the standard benchmark files are produced and
consumed.
"""
from __future__ import annotations

import numpy as np
import torch

from gbp_tpu_torch.io import _native
from gbp_tpu_torch.utils.lie import so3_exp, so3_log


def _so3_log(r):
    return so3_log(torch.as_tensor(np.asarray(r), dtype=torch.float64)).numpy()


def _so3_exp(w):
    return so3_exp(torch.as_tensor(np.asarray(w), dtype=torch.float64)).numpy()


def _conj_info_se2(info, theta_z):
    """Lam -> A Lam A^T with A = blockdiag(R(theta_z), 1) (see module docs)."""
    c, s = np.cos(theta_z), np.sin(theta_z)
    a = np.eye(3)
    a[:2, :2] = [[c, -s], [s, c]]
    return a @ info @ a.T


def _conj_info_se3(info, r_z):
    """Lam -> A Lam A^T with A = blockdiag(R_z, I_3) (see module docs)."""
    a = np.eye(6)
    a[:3, :3] = r_z
    return a @ info @ a.T


def _unpack_upper(vals, d):
    """Upper-triangular row-major entries -> symmetric [d, d]."""
    m = np.zeros((d, d))
    k = 0
    for i in range(d):
        for j in range(i, d):
            m[i, j] = m[j, i] = vals[k]
            k += 1
    return m


def _quat_to_rotmat(q):
    """[qx, qy, qz, qw] -> 3x3 rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _unpack_upper_batch(vals, d):
    """[m, d(d+1)/2] upper-triangular rows -> symmetric [m, d, d]."""
    iu = np.triu_indices(d)
    out = np.zeros((vals.shape[0], d, d))
    out[:, iu[0], iu[1]] = vals
    out[:, iu[1], iu[0]] = vals
    return out


def _quat_to_rotmat_batch(q):
    """[m, 4] (qx, qy, qz, qw) -> [m, 3, 3]."""
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def _dedupe_last(ids, rows):
    """The last definition of each vertex id (the line reader's dict
    semantics), rows in id order; the ids must be dense."""
    order = np.argsort(ids, kind="stable")
    ids_s, rows_s = ids[order], rows[order]
    last = np.ones(ids_s.size, bool)
    last[:-1] = ids_s[1:] != ids_s[:-1]
    if ids_s[last].tolist() != list(range(int(last.sum()))):
        raise ValueError("non-dense vertex ids")
    return rows_s[last]


def _assemble_native(raw):
    """The native tokenizer's raw rows -> the read_g2o dict."""
    if raw["v2_id"].size:
        poses = _dedupe_last(raw["v2_id"], raw["v2"])
        z = raw["e2"][:, :3]
        info = _unpack_upper_batch(raw["e2"][:, 3:9], 3)
        c, s = np.cos(z[:, 2]), np.sin(z[:, 2])
        a = np.tile(np.eye(3), (z.shape[0], 1, 1))
        a[:, 0, 0] = c
        a[:, 0, 1] = -s
        a[:, 1, 0] = s
        a[:, 1, 1] = c
        info = np.einsum("mij,mjk,mlk->mil", a, info, a)
        return dict(kind="se2", poses=poses, edges_ij=raw["e2_ij"], edges_z=z, edges_info=info)
    v3 = _dedupe_last(raw["v3_id"], raw["v3"])
    poses = np.concatenate([v3[:, :3], _so3_log(_quat_to_rotmat_batch(v3[:, 3:7]))], axis=1)
    e3 = raw["e3"]
    if e3.shape[0]:
        r_z = _quat_to_rotmat_batch(e3[:, 3:7])
        z = np.concatenate([e3[:, :3], _so3_log(r_z)], axis=1)
    else:
        r_z, z = np.zeros((0, 3, 3)), np.zeros((0, 6))
    info = _unpack_upper_batch(e3[:, 7:28], 6)
    a = np.tile(np.eye(6), (e3.shape[0], 1, 1))
    a[:, :3, :3] = r_z
    info = np.einsum("mij,mjk,mlk->mil", a, info, a)
    return dict(kind="se3", poses=poses, edges_ij=raw["e3_ij"], edges_z=z, edges_info=info)


def read_g2o(path):
    """Parse a g2o file -> dict (the native tokenizer where g++ is present,
    the line reader otherwise or where the native parse fails; the same
    output either way).

    SE2 graphs:
      poses:   [n, 3] (x, y, theta), index = vertex id (ids must be dense)
      edges_ij:[m, 2] int64
      edges_z: [m, 3] relative-pose measurements
      edges_info: [m, 3, 3] information matrices (for this package's
        residual: see the module docstring)
      kind: "se2"
    For SE3 graphs the pose rows are [x, y, z, omega(3)] (angle-axis) with
    kind "se3" and 6x6 information; quaternions are converted on load."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        raw = _native.parse_g2o_bytes(data)
    except ValueError:
        raw = None
    if raw is not None and (raw["v2_id"].size or raw["v3_id"].size):
        return _assemble_native(raw)
    return _read_g2o_python(path)


def _read_g2o_python(path):
    """The line reader (the same output as the native path)."""
    se2_v, se2_e = {}, []
    se3_v, se3_e = {}, []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            vals = [float(x) for x in parts[2:]] if tag.startswith("VERTEX") else \
                   [float(x) for x in parts[3:]]
            if tag == "VERTEX_SE2":
                se2_v[int(parts[1])] = np.array(vals[:3])
            elif tag == "EDGE_SE2":
                i, j = int(parts[1]), int(parts[2])
                z = np.array(vals[:3])
                info = _conj_info_se2(_unpack_upper(vals[3:9], 3), z[2])
                se2_e.append((i, j, z, info))
            elif tag == "VERTEX_SE3:QUAT":
                t = np.array(vals[:3])
                r = _quat_to_rotmat(np.array(vals[3:7]))
                w = _so3_log(r)
                se3_v[int(parts[1])] = np.concatenate([t, w])
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                t = np.array(vals[:3])
                r = _quat_to_rotmat(np.array(vals[3:7]))
                w = _so3_log(r)
                z = np.concatenate([t, w])
                info = _conj_info_se3(_unpack_upper(vals[7:28], 6), r)
                se3_e.append((i, j, z, info))
    if se2_v:
        ids = sorted(se2_v)
        if ids != list(range(len(ids))):
            raise ValueError("non-dense SE2 vertex ids")
        poses = np.stack([se2_v[i] for i in ids])
        ij = np.array([(i, j) for i, j, _, _ in se2_e], dtype=np.int64).reshape(-1, 2)
        z = np.stack([z for _, _, z, _ in se2_e]) if se2_e else np.zeros((0, 3))
        info = np.stack([m for _, _, _, m in se2_e]) if se2_e else np.zeros((0, 3, 3))
        return dict(kind="se2", poses=poses, edges_ij=ij, edges_z=z, edges_info=info)
    ids = sorted(se3_v)
    if ids != list(range(len(ids))):
        raise ValueError("non-dense SE3 vertex ids")
    poses = np.stack([se3_v[i] for i in ids])
    ij = np.array([(i, j) for i, j, _, _ in se3_e], dtype=np.int64).reshape(-1, 2)
    z = np.stack([z for _, _, z, _ in se3_e]) if se3_e else np.zeros((0, 6))
    info = np.stack([m for _, _, _, m in se3_e]) if se3_e else np.zeros((0, 6, 6))
    return dict(kind="se3", poses=poses, edges_ij=ij, edges_z=z, edges_info=info)


def _rotmat_to_quat(r):
    """3x3 rotation matrix -> [qx, qy, qz, qw] (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([
            (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
            (r[1, 0] - r[0, 1]) / s, 0.25 * s,
        ])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (r[j, i] + r[i, j]) / s
    q[k] = (r[k, i] + r[i, k]) / s
    q[3] = (r[k, j] - r[j, k]) / s
    return q


def write_g2o_se3(path, poses, edges_ij, edges_z, edges_info):
    """Write an SE3 g2o file; poses/edges_z are [*, 6] (t, omega) rows
    (inverse of read_g2o for kind='se3')."""
    poses = np.asarray(poses)
    edges_info = np.asarray(edges_info)
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            q = _rotmat_to_quat(_so3_exp(p[3:]))
            vals = " ".join(f"{x:.12g}" for x in np.concatenate([p[:3], q]))
            f.write(f"VERTEX_SE3:QUAT {i} {vals}\n")
        for (i, j), zrow, m in zip(np.asarray(edges_ij), np.asarray(edges_z),
                                   edges_info):
            r_z = _so3_exp(zrow[3:])
            q = _rotmat_to_quat(r_z)
            meas = " ".join(f"{x:.12g}" for x in np.concatenate([zrow[:3], q]))
            m = _conj_info_se3(m, r_z.T)  # back to g2o's error frame
            tri = [m[a, b] for a in range(6) for b in range(a, 6)]
            f.write(f"EDGE_SE3:QUAT {int(i)} {int(j)} {meas} "
                    + " ".join(f"{x:.12g}" for x in tri) + "\n")


def write_g2o_se2(path, poses, edges_ij, edges_z, edges_info):
    """Write an SE2 g2o file (inverse of read_g2o for kind='se2')."""
    poses = np.asarray(poses)
    edges_info = np.asarray(edges_info)
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            f.write(f"VERTEX_SE2 {i} {p[0]:.12g} {p[1]:.12g} {p[2]:.12g}\n")
        for (i, j), z, m in zip(np.asarray(edges_ij), np.asarray(edges_z), edges_info):
            m = _conj_info_se2(m, -z[2])  # back to g2o's error frame
            tri = [m[a, b] for a in range(3) for b in range(a, 3)]
            f.write(
                f"EDGE_SE2 {int(i)} {int(j)} {z[0]:.12g} {z[1]:.12g} {z[2]:.12g} "
                + " ".join(f"{x:.12g}" for x in tri) + "\n"
            )
