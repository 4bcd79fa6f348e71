"""Feature detection and matching in torch (counterpart of
gbp_tpu/frontend/features.py):

  * the Harris corner response (separable Gaussian window, Sobel gradients:
    correlations with the same zero padding as the reference's `lax.conv`,
    whose float32 sums they repeat bit for bit, see `_correlate`);
  * non-maximum suppression by max-pool equality, then the `max_corners`
    highest scores by a stable descending sort (static output size, with
    scores; ties go to the lower flat index, as `lax.top_k` breaks them);
  * bilinear patch descriptors, and zero-normalized cross-correlation (ZNCC)
    matching as one [N1, N2] product with mutual-nearest and ratio tests.

The reference computes all of this outside its Pallas kernels, so the port
is torch operations, with no hand-written kernel.  Every function works
on the device of its input tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_TINY = torch.finfo(torch.float32).tiny  # the least normal float32


def _gauss_kernel(sigma: float, radius: int, device=None):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _ftz(x):
    """x with its subnormal values flushed to (signed) zero, as the
    reference's CPU arithmetic flushes every float32 result: the Harris map
    is flushed after every operation, so that it equals the reference's bit
    for bit, and no flat-region response of 1e-45 passes for a corner."""
    return x * (x.abs() >= _TINY)


def _fma(a, b, c):
    """a * b + c of float32 tensors, rounded once to float32."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _correlate(x, k, dim: int):
    """1-D correlation of x [..., H, W] with the taps k along `dim` (-1: W,
    -2: H), zero padded to the same size.  The taps are added in the order
    of the reference's convolution on the CPU: products of neighbouring
    taps in pairs, the pairs from the left, an odd last tap at the end;
    each step is rounded to float32 and flushed (`_ftz`).  The Harris maxima
    and their ties depend on these bits (`F.conv2d` sums in another
    order)."""
    r, n = k.shape[0] // 2, x.shape[dim]
    xp = F.pad(x, (r, r) if dim == -1 else (0, 0, r, r))
    taps = [_ftz(k[i] * xp.narrow(dim, i, n)) for i in range(k.shape[0])]
    acc = None
    for i in range(0, k.shape[0] - 1, 2):
        pair = _ftz(taps[i] + taps[i + 1])
        acc = pair if acc is None else _ftz(acc + pair)
    return _ftz(acc + taps[-1]) if k.shape[0] % 2 else acc


def _sep_conv(img, kx, ky):
    """Separable 2D correlation with 'same' zero padding: img [..., H, W],
    kx along W, then ky along H."""
    return _correlate(_correlate(img, kx, -1), ky, -2)


def harris_response(img, sigma: float = 1.5, k: float = 0.04):
    """Harris corner response map of img [H, W] (or a batch [N, H, W]), in
    float32, subnormal values flushed to zero (`_ftz`)."""
    img = _ftz(img.to(torch.float32))
    dev = img.device
    sobel = torch.tensor([-0.5, 0.0, 0.5], dtype=torch.float32, device=dev)
    smooth = torch.tensor([0.25, 0.5, 0.25], dtype=torch.float32, device=dev)
    ix = _sep_conv(img, sobel, smooth)
    iy = _sep_conv(img, smooth, sobel)
    g = _gauss_kernel(sigma, max(1, int(2 * sigma)), dev)
    sxx = _sep_conv(_ftz(ix * ix), g, g)
    syy = _sep_conv(_ftz(iy * iy), g, g)
    sxy = _sep_conv(_ftz(ix * iy), g, g)
    # The reference's compiled map contracts these two lines into fused
    # multiply-adds, each rounded once: float64 holds a product of two
    # float32 values exactly, so one float64 step rounded to float32 is the
    # same number.
    det = _ftz(_fma(sxx, syy, -_ftz(sxy * sxy)))
    trace = _ftz(sxx + syy)
    return _ftz(_fma(-_ftz(k * trace), trace, det))


def detect(img, max_corners: int = 256, nms_radius: int = 4, border: int = 8):
    """Harris corners of img [H, W]: (xy [max_corners, 2] float32, score
    [max_corners]).

    Static output size; absent corners have score -inf (callers keep
    score > 0), and their xy are not defined.  xy is (col, row) = (u, v)."""
    resp = harris_response(img)
    h, w = resp.shape
    pooled = F.max_pool2d(resp[None, None], 2 * nms_radius + 1, stride=1,
                          padding=nms_radius)[0, 0]
    is_max = (resp == pooled) & (resp > 0)
    rows = torch.arange(h, device=resp.device)[:, None]
    cols = torch.arange(w, device=resp.device)[None, :]
    inside = (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)
    score = torch.where(is_max & inside, resp, -torch.inf).reshape(-1)
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:max_corners], idx[:max_corners]
    xy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
    return xy, top


def extract_patches(img, xy, size: int = 9):
    """Bilinear patch descriptors at subpixel centres xy [N, 2] -> [N, size *
    size], zero-normalized (mean-subtracted, unit norm: ready for ZNCC)."""
    img = img.to(torch.float32)
    h, w = img.shape
    r = size // 2
    off = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    gx = torch.clamp(xy[:, 0, None, None] + dx, 0.0, w - 1.001)
    gy = torch.clamp(xy[:, 1, None, None] + dy, 0.0, h - 1.001)
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    fx, fy = gx - x0, gy - y0
    v = (img[y0, x0] * (1 - fx) * (1 - fy)
         + img[y0, x0 + 1] * fx * (1 - fy)
         + img[y0 + 1, x0] * (1 - fx) * fy
         + img[y0 + 1, x0 + 1] * fx * fy)
    v = v.reshape(xy.shape[0], -1)
    v = v - v.mean(dim=1, keepdim=True)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-6)


def match(desc1, desc2, valid1=None, valid2=None, xy1=None, xy2=None,
          min_score: float = 0.7, ratio: float = 0.9, max_disp: float | None = None):
    """ZNCC brute-force matching: (match_idx [N1] int32, ok [N1] bool).

    match_idx[i] is the best j in desc2 for descriptor i (the first of equal
    scores); ok needs mutual nearest neighbours, ZNCC >= min_score and the
    ratio test (second best <= ratio * best + 1 - ratio).  With xy1 / xy2 and
    max_disp, candidates farther than max_disp pixels are excluded (the
    small-motion tracking gate)."""
    sim = desc1 @ desc2.T  # ZNCC in [-1, 1]
    if valid1 is not None:
        sim = torch.where(valid1[:, None], sim, -2.0)
    if valid2 is not None:
        sim = torch.where(valid2[None, :], sim, -2.0)
    if max_disp is not None:
        d2 = ((xy1[:, None, :] - xy2[None, :, :]) ** 2).sum(-1)
        sim = torch.where(d2 <= max_disp * max_disp, sim, -2.0)
    rows = torch.arange(sim.shape[0], device=sim.device)
    best_j = torch.argmax(sim, dim=1)
    best1 = sim.max(dim=1).values
    masked = sim.clone()
    masked[rows, best_j] = -2.0
    second = masked.max(dim=1).values
    best_i_of_j = torch.argmax(sim, dim=0)
    mutual = best_i_of_j[best_j] == rows
    ok = mutual & (best1 >= min_score) & (second <= ratio * best1 + (1 - ratio))
    return best_j.to(torch.int32), ok
