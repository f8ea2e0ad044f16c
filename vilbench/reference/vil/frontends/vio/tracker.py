"""Image feature detection + tracking: Shi-Tomasi corners and pyramidal
Lucas-Kanade (the image half of the ROVIO capability).

Port of ``vil_sensor_fusion_tpu/frontends/vio/tracker.py``. Every function
takes an image (H, W) or a batch of images (..., H, W) where the JAX one
is vmapped over frames. The arithmetic is kept in the JAX order, because
the detector's exact ``score >= neighbourhood max`` and its top-k turn on
near-ties:

- the separable filters stay padded shift-and-add passes with the taps in
  the same order (a convolution would sum in another order);
- non-max suppression is an exact max-pool with −inf padding;
- the top-k is a stable descending sort, so among equal scores the lower
  flat index comes first, as in ``lax.top_k``;
- KLT samples each feature's (win × win) window, clamped inside the image,
  through hat-weight matrices: a sample beyond the window's edge gets
  weight zero, exactly as in the JAX kernel. All features are tracked at
  once as batched matrix products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_conv1d(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """'same' 1-D correlation along ``axis`` (−1 or −2) as zero-padded
    shift-and-add, taps in order (zero taps skipped)."""
    if len(taps) % 2 != 1:
        raise ValueError(f"_shift_conv1d requires odd tap count, got {len(taps)}")
    r = len(taps) // 2
    pad = (r, r) if axis == -1 else (0, 0, r, r)
    p = F.pad(img, pad)
    n = img.shape[axis]
    out = None
    for i, t in enumerate(taps):
        if t == 0:
            continue
        term = p.narrow(axis, i, n) * t
        out = term if out is None else out + term
    return out


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients as separable shift-add passes:
    [-1 0 1]/8 ⊗ [1 2 1] (and transposed)."""
    dx = _shift_conv1d(img, (-1.0, 0.0, 1.0), axis=-1)
    dy = _shift_conv1d(img, (-1.0, 0.0, 1.0), axis=-2)
    gx = _shift_conv1d(dx, (0.125, 0.25, 0.125), axis=-2)
    gy = _shift_conv1d(dy, (0.125, 0.25, 0.125), axis=-1)
    return gx, gy


def _box(img: torch.Tensor, window: int) -> torch.Tensor:
    """Separable box filter: two 1-D shift-add passes."""
    taps = (1.0 / window,) * window
    return _shift_conv1d(_shift_conv1d(img, taps, axis=-2), taps, axis=-1)


def shi_tomasi(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Min-eigenvalue corner score per pixel."""
    gx, gy = sobel(img)
    gxx = _box(gx * gx, window)
    gyy = _box(gy * gy, window)
    gxy = _box(gx * gy, window)
    tr = 0.5 * (gxx + gyy)
    det = torch.sqrt(torch.clamp((0.5 * (gxx - gyy)) ** 2 + gxy ** 2,
                                 min=0.0))
    return tr - det


def detect(
    img: torch.Tensor,          # (..., H, W)
    n_features: int,
    nms_radius: int = 8,
    border: int = 12,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-N Shi-Tomasi corners with non-max suppression, exact (the JAX
    ``approx=False`` path; its TPU approximate top-k has no counterpart).

    Returns (uv (..., N, 2), score (..., N)); low-score slots are padding:
    −inf scores at the lowest flat indices that are no peak."""
    H, W = img.shape[-2:]
    batch = img.shape[:-2]
    score = shi_tomasi(img)
    k = 2 * nms_radius + 1
    s4 = score.reshape((-1, 1, H, W))
    mx = F.max_pool2d(s4, (k, 1), stride=1, padding=(nms_radius, 0))
    mx = F.max_pool2d(mx, (1, k), stride=1, padding=(0, nms_radius))
    is_peak = score >= mx.reshape(score.shape)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = ((yy >= border) & (yy < H - border)
              & (xx >= border) & (xx < W - border))
    masked = torch.where(is_peak & inside, score, -torch.inf)
    vals, idx = torch.sort(masked.reshape(batch + (H * W,)), dim=-1,
                           descending=True, stable=True)
    vals, idx = vals[..., :n_features], idx[..., :n_features]
    u = (idx % W).to(img.dtype)
    v = (idx // W).to(img.dtype)
    return torch.stack([u, v], dim=-1), vals


def bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of one (H, W) image at (…, 2) pixel coords
    (u = x/col, v = y/row)."""
    H, W = img.shape
    u = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    iu, iv = u0.long(), v0.long()
    i00 = img[iv, iu]
    i01 = img[iv, iu + 1]
    i10 = img[iv + 1, iu]
    i11 = img[iv + 1, iu + 1]
    return ((1 - dv) * ((1 - du) * i00 + du * i01)
            + dv * ((1 - du) * i10 + du * i11))


def pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """levels×2 downsampled pyramid (2×2 average pooling) of (..., H, W)."""
    out = [img]
    for _ in range(levels - 1):
        x = out[-1]
        H2, W2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
        x = x[..., :H2, :W2]
        out.append(0.25 * (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
                           + x[..., 1::2, 0::2] + x[..., 1::2, 1::2]))
    return out


def _hat_mat(center: torch.Tensor, offs: torch.Tensor,
             win: int) -> torch.Tensor:
    """Linear-interpolation weights: row i of feature n holds the hat
    weights of the window's columns for sample ``center[n] + offs[i]``
    (local window coordinates). (N,) centres → (N, P, win)."""
    pos = center[:, None] + offs[None, :]                    # (N, P)
    j = torch.arange(win, dtype=center.dtype, device=center.device)
    return torch.clamp(1.0 - torch.abs(pos[..., None] - j), min=0.0)


def klt_track(
    prev_pyr: list[torch.Tensor],
    next_pyr: list[torch.Tensor],
    uv_prev: torch.Tensor,      # (N, 2)
    valid: torch.Tensor,        # (N,)
    radius: int = 4,
    iters: int = 8,
    max_error: float = 12.0,
    margin: int = 6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal KLT: track features from prev to next frame.

    Per level, a (win × win) window, win = 2·(radius + margin) + 1, is cut
    around each feature from both images, its top-left corner
    round(uv) − (radius + margin) clamped inside the image; each
    Gauss-Newton iteration samples the (2r+1)² patch as A_v @ W @ A_uᵀ
    with hat-weight matrices. The capture range per level is ±``margin``
    px; a track that moves further fails the photometric check.

    Returns (uv_next (N, 2), valid (N,)); tracks failing convergence, image
    bounds, or the final photometric-error check are invalidated."""
    dtype, device = uv_prev.dtype, uv_prev.device
    levels = len(prev_pyr)
    r = radius
    win = 2 * (radius + margin) + 1
    offs = torch.arange(-r, r + 1, dtype=dtype, device=device)
    span = torch.arange(win, device=device)

    def extract_window(img, center_uv):
        """(N, win, win) windows and their corners (N, 2)."""
        H, W = img.shape
        c = torch.round(center_uv).long() - (r + margin)
        cx = torch.clamp(c[:, 0], 0, max(W - win, 0))
        cy = torch.clamp(c[:, 1], 0, max(H - win, 0))
        w = img[(cy[:, None] + span)[:, :, None],
                (cx[:, None] + span)[:, None, :]]
        return w, torch.stack([cx, cy], dim=-1).to(dtype)

    def sample(Wimg, local_uv):
        """Bilinear (2r+1)² patches at local window coords: (N, P, P)."""
        Au = _hat_mat(local_uv[:, 0], offs, win)
        Av = _hat_mat(local_uv[:, 1], offs, win)
        return Av @ Wimg @ Au.mT

    def track_level(uv_p, uv_n, prev_img, next_img):
        Wp, corner_p = extract_window(prev_img, uv_p)
        Wn, corner_n = extract_window(next_img, uv_n)
        lp = uv_p - corner_p                               # template centre
        tpl = sample(Wp, lp)
        # Gradients: central differences at ±0.5 px through shifted hats.
        eps = 0.5
        Au_p = _hat_mat(lp[:, 0] + eps, offs, win)
        Au_m = _hat_mat(lp[:, 0] - eps, offs, win)
        Av_p = _hat_mat(lp[:, 1] + eps, offs, win)
        Av_m = _hat_mat(lp[:, 1] - eps, offs, win)
        Av0 = _hat_mat(lp[:, 1], offs, win)
        Au0 = _hat_mat(lp[:, 0], offs, win)
        gx = Av0 @ Wp @ (Au_p - Au_m).mT / (2 * eps)
        gy = (Av_p - Av_m) @ Wp @ Au0.mT / (2 * eps)
        Gxx = torch.sum(gx * gx, dim=(-2, -1))
        Gxy = torch.sum(gx * gy, dim=(-2, -1))
        Gyy = torch.sum(gy * gy, dim=(-2, -1))
        det = Gxx * Gyy - Gxy * Gxy
        ok_G = det > 1e-6
        dn = torch.where(ok_G, det, 1.0)

        uv = uv_n
        for _ in range(iters):
            e = sample(Wn, uv - corner_n) - tpl
            bx = torch.sum(e * gx, dim=(-2, -1))
            by = torch.sum(e * gy, dim=(-2, -1))
            du = -(Gyy * bx - Gxy * by) / dn
            dv = -(-Gxy * bx + Gxx * by) / dn
            uv = uv + torch.where(ok_G[:, None], torch.stack([du, dv], -1),
                                  0.0)
        err = torch.mean(torch.abs(sample(Wn, uv - corner_n) - tpl),
                         dim=(-2, -1))
        return uv, ok_G, err

    uv0 = uv_prev
    uv = uv0 / 2.0 ** (levels - 1)
    ok = valid > 0
    for lvl in range(levels - 1, -1, -1):
        uv, ok_G, err = track_level(uv0 / 2.0 ** lvl, uv, prev_pyr[lvl],
                                    next_pyr[lvl])
        ok = ok & ok_G
        if lvl > 0:
            uv = uv * 2.0
    # Final validity: in bounds + level-0 photometric error.
    H, W = next_pyr[0].shape
    inb = ((uv[:, 0] > radius + 1) & (uv[:, 0] < W - radius - 2)
           & (uv[:, 1] > radius + 1) & (uv[:, 1] < H - radius - 2))
    ok = ok & inb & (err < max_error)
    return uv, ok.to(dtype)
