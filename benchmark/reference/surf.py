"""SURF feature detection and description, batch-first over bands.

Counterpart of spherical_bundle_adjuster_tpu/ops/surf.py. Every function
takes a leading batch of B bands (the JAX package vmapped a single-band
function over them):

  * integral image, then the det-of-Hessian pyramid per octave on the
    octave's stride grid (surf_maps.det_pyramid_plain)
  * 3x3x3 non-max suppression, global exact top-K over all octaves with a
    lossless 2x2 block-argmax pre-reduction, 27-tap subpixel refine
  * Haar and trace-sign maps (surf_maps.haar_trace_maps_plain) — then
    the Laplacian sign and the 72-bin sliding-window orientation
  * 21x21-sample, 4x4-pooled, 64-d descriptor

Fixed choices where the reference has TPU-only modes: keypoints are
selected with an exact, stable top-K (`torch.sort(stable=True)`, the
lower index first on ties, as lax.top_k); with descriptor_interp
"nearest" the gray band is rounded to integers before descriptor
sampling (the reference's MXU gather path, which the bench gates were
calibrated on); the dense maps come from surf_maps' plain versions. The
port's SurfConfig has no `gather_mode`, `mxu_gather_chunk`, `topk_mode`,
`topk_recall` or `det_mode`.

The optional modes: descriptor_interp="bilinear" samples the (unrounded)
gray band bilinearly; laplacian_mode="gather" reads each keypoint's
Laplacian sign from 24 integral-image corners at its own rounded size
instead of the K2 trace-sign map of its detection layer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import smallmat
from .config import SurfConfig
from . import integral, surf_maps


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint sets, (B, K) per field (K = max_keypoints).

    xy: (B, K, 2) pixel coords (x, y); size: filter size in pixels;
    response: det-of-Hessian; orientation: radians; laplacian: sign of
    trace; valid: bool mask — invalid slots carry zeros (size 1).
    """

    xy: torch.Tensor
    size: torch.Tensor
    response: torch.Tensor
    orientation: torch.Tensor
    laplacian: torch.Tensor
    valid: torch.Tensor

    @property
    def scale(self):
        """SURF scale s = size * 1.2 / 9 (OpenCV convention)."""
        return self.size * (1.2 / 9.0)


def _nms_candidates(det_list, cfg: SurfConfig):
    """Middle-layer scores that are 3x3x3 local maxima above the Hessian
    threshold, -inf elsewhere: list of (B, n_mid, oh, ow)."""
    out = []
    for stack in det_list:
        # max pooling pads with -inf, as the reference's reduce_window
        m = F.max_pool3d(stack[:, None], 3, stride=1, padding=1)[:, 0]
        mid = stack[:, 1:-1]
        is_max = (mid >= m[:, 1:-1]) & (mid > cfg.hessian_threshold)
        out.append(torch.where(is_max, mid, -torch.inf))
    return out


def _refine_and_pack(det_list, cand_list, cfg: SurfConfig):
    """Global exact top-K + subpixel/scale refinement -> Keypoints fields
    (orientation and laplacian still zero), batched over bands.

    NMS leaves at most one maximum per 2x2 block of one layer's grid, so a
    2x2 block-argmax first shrinks the top-K input 4x without losing a
    candidate (ties aside)."""
    k = cfg.max_keypoints
    red_list, sub_list = [], []
    for c in cand_list:
        b, n_mid, oh, ow = c.shape
        ph, pw = (oh + 1) // 2 * 2, (ow + 1) // 2 * 2
        gp = F.pad(c, (0, pw - ow, 0, ph - oh), value=-math.inf)
        blk = gp.reshape(b, n_mid, ph // 2, 2, pw // 2, 2).permute(0, 1, 2, 4, 3, 5)
        blk = blk.reshape(b, n_mid, ph // 2, pw // 2, 4)
        red_list.append(torch.amax(blk, dim=-1))
        sub_list.append(torch.argmax(blk, dim=-1))  # first max, as jnp.argmax

    flats = [r.reshape(r.shape[0], -1) for r in red_list]
    offsets = [0]
    for f in flats:
        offsets.append(offsets[-1] + f.shape[1])
    flat = torch.cat(flats, dim=1)
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    valid = torch.isfinite(scores)

    zeros = torch.zeros_like(idx)
    oct_i, layer, y, x, step_arr = zeros, zeros, zeros, zeros, zeros
    for o, (red, sub, c) in enumerate(zip(red_list, sub_list, cand_list)):
        _, _, rh, rw = red.shape
        oh, ow = c.shape[2], c.shape[3]
        in_oct = (idx >= offsets[o]) & (idx < offsets[o + 1])
        local = torch.clamp(idx - offsets[o], 0, offsets[o + 1] - offsets[o] - 1)
        l_o = local // (rh * rw)
        rem = local % (rh * rw)
        s_o = torch.gather(sub.reshape(sub.shape[0], -1), 1, local)
        y_o = torch.clamp((rem // rw) * 2 + s_o // 2, max=oh - 1)
        x_o = torch.clamp((rem % rw) * 2 + s_o % 2, max=ow - 1)
        oct_i = torch.where(in_oct, o, oct_i)
        layer = torch.where(in_oct, l_o + 1, layer)
        y = torch.where(in_oct, y_o, y)
        x = torch.where(in_oct, x_o, x)
        step_arr = torch.where(in_oct, 1 << o, step_arr)

    # 3x3x3 neighbourhood on the keypoint's own octave grid: one gather of
    # K*27 elements from the concatenated det buffer.
    dev = idx.device
    offs = torch.tensor(
        [(dl, dy, dx) for dl in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
        dtype=torch.int64, device=dev,
    )
    dls, dys, dxs = offs[:, 0], offs[:, 1], offs[:, 2]
    det_flat = torch.cat([s.reshape(s.shape[0], -1) for s in det_list], dim=1)
    lin27 = torch.zeros(idx.shape + (27,), dtype=torch.int64, device=dev)
    doff = 0
    for o, stack in enumerate(det_list):
        _, n_l, oh, ow = stack.shape
        ll = torch.clamp(layer[..., None] + dls, 0, n_l - 1)
        yy = torch.clamp(y[..., None] + dys, 0, oh - 1)
        xx = torch.clamp(x[..., None] + dxs, 0, ow - 1)
        lin = doff + (ll * oh + yy) * ow + xx
        lin27 = torch.where((oct_i == o)[..., None], lin, lin27)
        doff += n_l * oh * ow
    v27 = torch.gather(det_flat, 1, lin27.reshape(idx.shape[0], -1)).reshape(lin27.shape)
    n27 = torch.where(torch.isfinite(v27), v27, torch.zeros_like(v27))

    def nb(dl, dy, dx):
        return n27[..., (dl + 1) * 9 + (dy + 1) * 3 + (dx + 1)]

    d000 = nb(0, 0, 0)
    gs = 0.5 * (nb(1, 0, 0) - nb(-1, 0, 0))
    gy = 0.5 * (nb(0, 1, 0) - nb(0, -1, 0))
    gx = 0.5 * (nb(0, 0, 1) - nb(0, 0, -1))
    hss = nb(1, 0, 0) + nb(-1, 0, 0) - 2 * d000
    hyy = nb(0, 1, 0) + nb(0, -1, 0) - 2 * d000
    hxx = nb(0, 0, 1) + nb(0, 0, -1) - 2 * d000
    hsy = 0.25 * (nb(1, 1, 0) - nb(1, -1, 0) - nb(-1, 1, 0) + nb(-1, -1, 0))
    hsx = 0.25 * (nb(1, 0, 1) - nb(1, 0, -1) - nb(-1, 0, 1) + nb(-1, 0, -1))
    hyx = 0.25 * (nb(0, 1, 1) - nb(0, 1, -1) - nb(0, -1, 1) + nb(0, -1, -1))
    H3 = torch.stack(
        [
            torch.stack([hss, hsy, hsx], -1),
            torch.stack([hsy, hyy, hyx], -1),
            torch.stack([hsx, hyx, hxx], -1),
        ],
        -2,
    )
    g3 = torch.stack([gs, gy, gx], -1)
    eye = torch.eye(3, dtype=H3.dtype, device=dev) * 1e-6
    delta = -smallmat.solve3(H3 + eye, g3)
    delta = torch.nan_to_num(torch.clamp(delta, -1.0, 1.0))

    stepf = step_arr.to(torch.float32)
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    base_size = (9.0 + 6.0 * layer.to(torch.float32)) * stepf
    if cfg.subpixel_refine:
        size = base_size + delta[..., 0] * (6.0 * stepf)
        xy = torch.stack([(xf + delta[..., 2]) * stepf, (yf + delta[..., 1]) * stepf], -1)
    else:
        size = base_size
        xy = torch.stack([xf * stepf, yf * stepf], -1)
    zero = torch.zeros_like(size)
    return Keypoints(
        xy=torch.where(valid[..., None], xy, 0.0),
        size=torch.where(valid, size, 1.0),
        response=torch.where(valid, scores, 0.0),
        orientation=zero,
        laplacian=zero,
        valid=valid,
    )


def _layer_index(kp_size, cfg: SurfConfig):
    """Nearest middle-layer index for each keypoint's (continuous) size
    (first minimum on ties, as jnp.argmin)."""
    sizes = torch.tensor(
        surf_maps.mid_layer_sizes(cfg), dtype=torch.float32, device=kp_size.device
    )
    return torch.argmin(torch.abs(kp_size[..., None] - sizes), dim=-1)


def _sample_maps(maps, q, yi, xi):
    """maps (B, Q, h, w); q (B, K); yi, xi (B, K, ...) -> maps[b, q, yi, xi]."""
    b, nq, h, w = maps.shape
    bi = torch.arange(b, device=maps.device).reshape((b,) + (1,) * (yi.ndim - 1))
    qe = q.reshape(q.shape + (1,) * (yi.ndim - 2))
    lin = ((bi * nq + qe) * h + yi) * w + xi
    return maps.reshape(-1)[lin]


def _lap_from_trace_maps(maps, kp: Keypoints, cfg: SurfConfig):
    """Laplacian sign: one gather per keypoint from the trace-sign maps."""
    h, w = maps.shape[2], maps.shape[3]
    li = _layer_index(kp.size, cfg)
    x = torch.clamp(torch.round(kp.xy[..., 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(kp.xy[..., 1]).to(torch.int64), 0, h - 1)
    return _sample_maps(maps, li, y, x).to(torch.float32)


# The gather-mode trace: Dyy boxes over row slots (0, 1), (1, 2), (2, 3)
# x column slots (4, 5), Dxx boxes over rows (4, 5) x columns (0, 1),
# (1, 2), (2, 3), weights (1, -2, 1); each box's four corners
# (y1, x1, +), (y0, x1, -), (y1, x0, -), (y0, x0, +).
_TRACE_BOXES = ([(i, i + 1, 4, 5, wt) for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))]
                + [(4, 5, i, i + 1, wt) for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))])
_TRACE_CORNERS = [(rr, cc, wt * sgn) for (r0, r1, c0, c1, wt) in _TRACE_BOXES
                  for (rr, cc, sgn) in ((r1, c1, 1.0), (r0, c1, -1.0), (r1, c0, -1.0),
                                        (r0, c0, 1.0))]


def _lap_from_corners(ii, kp: Keypoints):
    """Laplacian sign (laplacian_mode="gather"): sign(Dxx + Dyy) of the
    thirds-geometry trace at each keypoint's rounded size, from 24 corners
    of the integral image ii (B, h+1, w+1) with slot offsets {0, t, 2t,
    3t, b, size - b}, t = size / 3 and b = 2 size / 9 truncated."""
    h, w = ii.shape[1] - 1, ii.shape[2] - 1
    size = torch.round(kp.size).to(torch.int64)
    half = torch.div(size, 2, rounding_mode="floor")
    x = torch.round(kp.xy[..., 0]).to(torch.int64) - half
    y = torch.round(kp.xy[..., 1]).to(torch.int64) - half
    third = (size.to(torch.float32) / 3.0).to(torch.int64)
    b = (2.0 * size.to(torch.float32) / 9.0).to(torch.int64)
    slots = torch.stack([torch.zeros_like(size), third, 2 * third, 3 * third, b, size - b], -1)
    rows = torch.clamp(y[..., None] + slots, 0, h)  # (B, K, 6)
    cols = torch.clamp(x[..., None] + slots, 0, w)
    dev = ii.device
    cr = torch.tensor([c[0] for c in _TRACE_CORNERS], device=dev)
    cc = torch.tensor([c[1] for c in _TRACE_CORNERS], device=dev)
    coef = torch.tensor([c[2] for c in _TRACE_CORNERS], dtype=torch.float32, device=dev)
    bi = torch.arange(ii.shape[0], device=dev)[:, None, None]
    v = ii[bi, rows[..., cr], cols[..., cc]]  # (B, K, 24)
    return torch.sign(torch.sum(v * coef, dim=-1))


def _assign_orientation(kp: Keypoints, hx_maps, hy_maps, cfg: SurfConfig):
    """Dominant orientation per keypoint (classic SURF sliding window).

    Samples the bf16 Haar maps on the 13x13 grid (disc of radius 6s,
    Gaussian sigma 2.5) around each keypoint at its detection layer, bins
    the responses into a 72-bin circular histogram and sums 12 adjacent
    bins per 5-degree window centre — exactly the sliding pi/3 window."""
    if cfg.upright:
        return torch.zeros_like(kp.size)
    dev = kp.xy.device
    h, w = hx_maps.shape[2], hx_maps.shape[3]
    s = kp.scale
    q = _layer_index(kp.size, cfg)
    b, k = s.shape

    grid = torch.arange(-6, 7, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")  # [r, j] = (dy, dx)
    rr = gx * gx + gy * gy
    wts = torch.where(rr <= 36.0, torch.exp(-rr / (2.0 * 2.5**2)), 0.0)

    cy = torch.clamp(
        torch.round(kp.xy[..., 1:2] + grid * s[..., None]).to(torch.int64), 0, h - 1
    )  # (B, K, 13) row per row offset
    cx = torch.clamp(
        torch.round(kp.xy[..., 0:1] + grid * s[..., None]).to(torch.int64), 0, w - 1
    )  # (B, K, 13) col per col offset
    yi, xi = cy[..., :, None], cx[..., None, :]  # (B, K, 13, 1), (B, K, 1, 13)
    yi, xi = torch.broadcast_tensors(yi, xi)
    hx = _sample_maps(hx_maps, q, yi, xi).to(torch.float32)
    hy = _sample_maps(hy_maps, q, yi, xi).to(torch.float32)
    hx = (hx * wts).reshape(b, k, -1)  # weights are zero outside the disc
    hy = (hy * wts).reshape(b, k, -1)
    ang = torch.atan2(hy, hx)

    nbins = 72
    bins = torch.clamp(
        torch.floor((ang + math.pi) / (2 * math.pi) * nbins).to(torch.int64),
        0, nbins - 1,
    )
    onehot = F.one_hot(bins, nbins).to(torch.float32)  # (B, K, N, 72)
    hist_x = torch.einsum("bknc,bkn->bkc", onehot, hx)
    hist_y = torch.einsum("bknc,bkn->bkc", onehot, hy)
    # window j covers bins with (bin - j) mod 72 in {-6, ..., 5}
    sx = sum(torch.roll(hist_x, -d, dims=-1) for d in range(-6, 6))
    sy = sum(torch.roll(hist_y, -d, dims=-1) for d in range(-6, 6))
    mag = sx * sx + sy * sy
    best = torch.argmax(mag, dim=-1, keepdim=True)
    bx = torch.gather(sx, -1, best)[..., 0]
    by = torch.gather(sy, -1, best)[..., 0]
    return torch.atan2(by, bx)


def _descriptor_grid(device):
    """21x21 sample offsets centred on the keypoint (units of s)."""
    r = torch.arange(21, dtype=torch.float32, device=device) - 10.0
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    return gx, gy


def _gauss20(device):
    """Gaussian weights (sigma 3.3) over the 20x20 derivative grid."""
    r = torch.arange(20, dtype=torch.float32, device=device) - 9.5
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    return torch.exp(-(gx * gx + gy * gy) / (2.0 * 3.3**2))


def describe(gray, kp: Keypoints, cfg: SurfConfig):
    """64-d SURF descriptors (B, K, 64), L2-normalized; zero rows for
    invalid slots. Samples the integer-rounded gray (OpenCV's 8-bit
    quantization) at the nearest pixel of a rotated 21x21 grid, or the
    gray band itself bilinearly (descriptor_interp="bilinear")."""
    b, h, w = gray.shape
    dev = gray.device
    gxs, gys = _descriptor_grid(dev)
    s = kp.scale[..., None, None]
    co = torch.cos(kp.orientation)[..., None, None]
    si = torch.sin(kp.orientation)[..., None, None]
    px = kp.xy[..., 0, None, None] + s * (co * gxs - si * gys)
    py = kp.xy[..., 1, None, None] + s * (si * gxs + co * gys)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    if cfg.descriptor_interp == "bilinear":
        x0, y0 = torch.floor(px), torch.floor(py)
        fx, fy = px - x0, py - y0
        x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
        y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
        x1i = torch.clamp(x0i + 1, 0, w - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        flat = gray.reshape(-1)

        def at(yy, xx):
            return flat[(bi * h + yy) * w + xx]

        patch = (at(y0i, x0i) * (1 - fx) * (1 - fy) + at(y0i, x1i) * fx * (1 - fy)
                 + at(y1i, x0i) * (1 - fx) * fy + at(y1i, x1i) * fx * fy)  # (B, K, 21, 21)
    elif cfg.descriptor_interp == "nearest":
        xi = torch.clamp(torch.round(px).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.round(py).to(torch.int64), 0, h - 1)
        patch = torch.round(gray).reshape(-1)[(bi * h + yi) * w + xi]  # (B, K, 21, 21)
    else:
        raise ValueError(f"unknown descriptor_interp {cfg.descriptor_interp!r}")

    dx = 0.5 * (
        patch[..., :-1, 1:] - patch[..., :-1, :-1] + patch[..., 1:, 1:] - patch[..., 1:, :-1]
    )
    dy = 0.5 * (
        patch[..., 1:, :-1] - patch[..., :-1, :-1] + patch[..., 1:, 1:] - patch[..., :-1, 1:]
    )
    gw = _gauss20(dev)
    dx = dx * gw
    dy = dy * gw

    def pool(v):  # 4x4 subregions of 5x5 samples
        return v.reshape(v.shape[:-2] + (4, 5, 4, 5)).sum(dim=(-3, -1))

    feats = torch.stack(
        [pool(dx), pool(torch.abs(dx)), pool(dy), pool(torch.abs(dy))], dim=-1
    )
    desc = feats.reshape(feats.shape[:-3] + (64,))
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-12)
    return torch.where(kp.valid[..., None], desc, 0.0)


def detect(gray, cfg: SurfConfig = SurfConfig()):
    """Up to cfg.max_keypoints SURF keypoints per band of gray (B, H, W),
    with orientation and Laplacian sign filled in."""
    if cfg.laplacian_mode not in ("dense", "gather"):
        raise ValueError(f"unknown laplacian_mode {cfg.laplacian_mode!r}")
    gray = gray.to(torch.float32)
    ii = integral.integral_image(gray)
    det_list = surf_maps.det_pyramid_plain(ii, cfg)  # per octave, -inf outside the border
    cand_list = _nms_candidates(det_list, cfg)
    kp = _refine_and_pack(det_list, cand_list, cfg)
    hx_maps, hy_maps, trace_maps = surf_maps.haar_trace_maps_plain(ii, cfg)
    lap = (_lap_from_trace_maps(trace_maps, kp, cfg) if cfg.laplacian_mode == "dense"
           else _lap_from_corners(ii, kp))
    ori = _assign_orientation(kp, hx_maps, hy_maps, cfg)
    return kp._replace(
        orientation=torch.where(kp.valid, ori, 0.0),
        laplacian=torch.where(kp.valid, lap, 0.0),
    )


def detect_and_describe(images, cfg: SurfConfig = SurfConfig()):
    """Bands (B, H, W) gray or (B, H, W, 3) RGB -> (Keypoints, (B, K, 64))."""
    gray = integral.rgb_to_gray(images) if images.ndim == 4 else images.to(torch.float32)
    kp = detect(gray, cfg)
    return kp, describe(gray, kp, cfg)
