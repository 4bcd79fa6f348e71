"""Component-major small-matrix algebra: the plain PyTorch version.

Counterpart of gbp_tpu/ops/comp_linalg.py.  A d x d matrix is a list of
lists of d*d tensors, each holding one matrix COMPONENT for a whole batch of
factors (one row of the [F, rows] component-major state); vectors are lists
of tensors.  Every operation is elementwise over the batch, in the same
order as the reference, so float64 results agree with it to roundoff.

csrc/comp_linalg.cuh is the same algebra for one factor per CUDA thread;
the kernels in csrc/messages.cu use it and ops/messages.py holds them
against the plain versions built from this module.
"""
from __future__ import annotations

import torch


def ct(a):
    """Transpose a component matrix."""
    return [[a[i][j] for i in range(len(a))] for j in range(len(a[0]))]


def cmm(a, b):
    """Matrix product: [r x k] @ [k x c]."""
    r, k, c = len(a), len(b), len(b[0])
    return [[sum(a[i][s] * b[s][j] for s in range(k)) for j in range(c)]
            for i in range(r)]


def cmv(a, v):
    """Matrix-vector product: [r x k] @ [k]."""
    return [sum(a[i][s] * v[s] for s in range(len(v))) for i in range(len(a))]


def cadd(a, b):
    return [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def csub(a, b):
    return [[x - y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def cscale(a, s):
    return [[x * s for x in r] for r in a]


def vadd(u, v):
    return [x + y for x, y in zip(u, v)]


def vsub(u, v):
    return [x - y for x, y in zip(u, v)]


def csym(a):
    d = len(a)
    return [[0.5 * (a[i][j] + a[j][i]) for j in range(d)] for i in range(d)]


def _inv2(a):
    inv_det = 1.0 / (a[0][0] * a[1][1] - a[0][1] * a[0][1])
    return [
        [a[1][1] * inv_det, -a[0][1] * inv_det],
        [-a[0][1] * inv_det, a[0][0] * inv_det],
    ]


def _inv3(a):
    c00 = a[1][1] * a[2][2] - a[1][2] * a[1][2]
    c01 = a[0][2] * a[1][2] - a[0][1] * a[2][2]
    c02 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[0][2]
    c12 = a[0][1] * a[0][2] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[0][1]
    inv_det = 1.0 / (a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02)
    return [
        [c00 * inv_det, c01 * inv_det, c02 * inv_det],
        [c01 * inv_det, c11 * inv_det, c12 * inv_det],
        [c02 * inv_det, c12 * inv_det, c22 * inv_det],
    ]


def csym_inv(a):
    """Symmetric inverse: closed forms d <= 3, 2x2-block Schur recursion
    above (split d1 = ceil(d/2))."""
    d = len(a)
    if d == 1:
        return [[1.0 / a[0][0]]]
    if d == 2:
        return _inv2(a)
    if d == 3:
        return _inv3(a)
    d1 = (d + 1) // 2
    p = [[a[i][j] for j in range(d1)] for i in range(d1)]
    q = [[a[i][j] for j in range(d1, d)] for i in range(d1)]
    s = [[a[i][j] for j in range(d1, d)] for i in range(d1, d)]
    p_inv = csym_inv(p)
    pq = cmm(p_inv, q)
    schur_inv = csym_inv(csub(s, cmm(ct(q), pq)))
    tr = cscale(cmm(pq, schur_inv), -1.0)
    tl = cadd(p_inv, cmm(cmm(pq, schur_inv), ct(pq)))
    out = [[None] * d for _ in range(d)]
    for i in range(d1):
        for j in range(d1):
            out[i][j] = tl[i][j]
        for j in range(d - d1):
            out[i][d1 + j] = tr[i][j]
            out[d1 + j][i] = tr[i][j]
    for i in range(d - d1):
        for j in range(d - d1):
            out[d1 + i][d1 + j] = schur_inv[i][j]
    return out


def cscaled_sym_inv(a, eps=1e-30):
    """f32-safe inverse: Jacobi-normalize to unit diagonal, invert, undo."""
    d = len(a)
    if d == 1:
        return [[1.0 / a[0][0]]]
    s = [torch.sqrt(torch.clamp(a[i][i], min=eps)) for i in range(d)]
    a_n = [[a[i][j] / (s[i] * s[j]) for j in range(d)] for i in range(d)]
    inv_n = csym_inv(a_n)
    return [[inv_n[i][j] / (s[i] * s[j]) for j in range(d)] for i in range(d)]
