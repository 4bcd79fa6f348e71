"""Closed-form batched small symmetric-matrix linear algebra in torch.

Counterpart of gbp_tpu/utils/smalllinalg.py with the same closed forms and
the same recursion, so that f64 results agree to roundoff:

  d = 1      : reciprocal
  d = 2, 3   : adjugate / cofactor expansion
  d >= 4     : recursive 2x2-block Schur complement, split d1 = ceil(d/2),
               bottoming out at the closed forms.

Every function takes `...` leading batch dims.  Products are written as
broadcast-multiply + sum (not torch.matmul), which keeps the summation
order of the reference and never routes a float32 product through TF32.
"""
from __future__ import annotations

import torch


def bmm(a, b):
    """Batched tiny-matrix product [..., i, k] x [..., k, j] -> [..., i, j]."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def bmv(a, v):
    """Batched tiny matrix-vector product [..., i, k] x [..., k] -> [..., i]."""
    return (a * v[..., None, :]).sum(-1)


def bT(a):
    return a.transpose(-1, -2)


def sym_inv2(a):
    """Inverse of [..., 2, 2] symmetric matrices."""
    a00, a01, a11 = a[..., 0, 0], a[..., 0, 1], a[..., 1, 1]
    inv_det = 1.0 / (a00 * a11 - a01 * a01)
    row0 = torch.stack([a11 * inv_det, -a01 * inv_det], dim=-1)
    row1 = torch.stack([-a01 * inv_det, a00 * inv_det], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def sym_inv3(a):
    """Inverse of [..., 3, 3] symmetric matrices via adjugate."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    inv_det = 1.0 / (a00 * c00 + a01 * c01 + a02 * c02)
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c01, c11, c12], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def _sym_inv_rec(a, d: int):
    if d == 1:
        return 1.0 / a
    if d == 2:
        return sym_inv2(a)
    if d == 3:
        return sym_inv3(a)
    d1 = (d + 1) // 2
    # A = [[P, Q], [Q^T, S]];  block-Schur inverse.
    p = a[..., :d1, :d1]
    q = a[..., :d1, d1:]
    s = a[..., d1:, d1:]
    p_inv = _sym_inv_rec(p, d1)
    pq = bmm(p_inv, q)
    schur_inv = _sym_inv_rec(s - bmm(bT(q), pq), d - d1)
    top_right = -bmm(pq, schur_inv)
    top_left = p_inv + bmm(bmm(pq, schur_inv), bT(pq))
    top = torch.cat([top_left, top_right], dim=-1)
    bottom = torch.cat([bT(top_right), schur_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def sym_inv(a, d: int | None = None):
    """Inverse of [..., d, d] symmetric (PD-ish) matrices, closed-form unrolled."""
    if d is None:
        d = a.shape[-1]
    if d < 1 or a.shape[-1] != d or a.shape[-2] != d:
        raise ValueError(f"expected [..., {d}, {d}] with d >= 1, got {tuple(a.shape)}")
    return _sym_inv_rec(a, d)


def sym_solve(a, b):
    """Solve A x = b for symmetric [..., d, d] A and [..., d] b."""
    d = a.shape[-1]
    if d == 1:
        return b / a[..., 0]
    return bmv(sym_inv(a, d), b)


def symmetrize(a):
    return 0.5 * (a + a.transpose(-1, -2))


def _jacobi_scale(a):
    """sqrt(diag(a)) clamped away from zero, for D^-1 A D^-1 normalization."""
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    return torch.sqrt(torch.clamp(diag, min=1e-30))


def scaled_sym_inv(a, d: int | None = None):
    """f32-safe inverse: Jacobi-normalize (unit diagonal), invert, un-normalize.

    D^-1 (D^-1 A D^-1)^-1 D^-1 is algebraically A^-1 and keeps the
    intermediates O(1) for blocks whose diagonal spans many decades."""
    if d is None:
        d = a.shape[-1]
    if d == 1:
        return 1.0 / a
    s = _jacobi_scale(a)
    ss = s[..., :, None] * s[..., None, :]
    return sym_inv(a / ss, d) / ss


def scaled_sym_solve(a, b):
    """f32-safe solve via the Jacobi-normalized inverse."""
    d = a.shape[-1]
    if d == 1:
        return b / a[..., 0]
    s = _jacobi_scale(a)
    inv_n = sym_inv(a / (s[..., :, None] * s[..., None, :]), d)
    return bmv(inv_n, b / s) / s
