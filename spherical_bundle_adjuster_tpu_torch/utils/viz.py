"""Host-side visualization parity with the reference (C13), ported from
the JAX package's utils/viz.py:

  * draw_match — left/right gray channels overlaid in one RGB image with
    rainbow match lines (feature_matcher.cpp:61-86)
  * write_d_circle — depth-colored circles on the left image
    (spherical_bundle_adjuster.cpp:227-253): green intensity ~ d/max for
    d >= 0, red for negative depths
  * eval overlay — green inlier / red outlier lines on the right image
    (test/feature_test.cpp:83-100)

numpy + PIL (no OpenCV), pure host code: each argument, a tensor on any
device or an array, is pulled to numpy once, and the drawing makes the
JAX package's PIL calls on the same float coordinates, so both packages
give the same pixels.
"""

from __future__ import annotations

import colorsys
import os

import numpy as np
import torch
from PIL import Image, ImageDraw


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gray(img):
    img = _to_np(img).astype(np.float32)
    if img.ndim == 3:
        img = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return np.clip(img, 0, 255).astype(np.uint8)


def draw_match(im_left, im_right, left_xy, right_xy, valid=None):
    """Overlay image: R channel = left gray, G channel = right gray, with
    HSV-rainbow lines between matched keypoints. Returns (H, W, 3) uint8."""
    gl = _gray(im_left)
    gr = _gray(im_right)
    overlay = np.stack([gl, gr, np.zeros_like(gl)], axis=-1)
    img = Image.fromarray(overlay)
    drw = ImageDraw.Draw(img)
    lxy = _to_np(left_xy)
    rxy = _to_np(right_xy)
    v = np.ones(len(lxy), bool) if valid is None else _to_np(valid).astype(bool)
    n = max(int(v.sum()), 1)
    ci = 0
    for i in range(len(lxy)):
        if not v[i]:
            continue
        r, g, b = colorsys.hsv_to_rgb(ci / n, 1.0, 0.6)
        drw.line(
            [tuple(lxy[i]), tuple(rxy[i])],
            fill=(int(r * 255), int(g * 255), int(b * 255)),
            width=2,
        )
        ci += 1
    return np.asarray(img)


def _base_rgb(im):
    base = _to_np(im)
    if base.ndim == 2:
        base = np.stack([base] * 3, axis=-1)
    return np.clip(base, 0, 255).astype(np.uint8)


def draw_depth_circles(im_left, depths, left_xy, valid=None, radius=10):
    """Depth visualization (write_d_circle): green circles scaled by
    d/max(d) for non-negative left depths, red for negative."""
    img = Image.fromarray(_base_rgb(im_left))
    drw = ImageDraw.Draw(img)
    d = _to_np(depths)
    d0 = d[:, 0] if d.ndim == 2 else d
    xy = _to_np(left_xy)
    v = np.ones(len(xy), bool) if valid is None else _to_np(valid).astype(bool)
    if not v.any():
        return np.asarray(img)
    max_d = max(float(d0[v].max()), 1e-9)
    min_d = min(float(d0[v].min()), -1e-9)
    for i in range(len(xy)):
        if not v[i]:
            continue
        x, y = float(xy[i][0]), float(xy[i][1])
        if d0[i] >= 0:
            col = (0, int(np.clip(d0[i] * 255.0 / max_d, 0, 255)), 0)
        else:
            col = (int(np.clip(255 - d0[i] * 255.0 / min_d, 0, 255)), 0, 0)
        drw.ellipse([x - radius, y - radius, x + radius, y + radius], outline=col, width=3)
    return np.asarray(img)


def draw_eval_overlay(im_right, left_xy_rot, right_xy, diffs, threshold, valid=None):
    """Green lines for inliers (diff <= threshold), red for outliers,
    from the GT-rotated left keypoint to the matched right keypoint."""
    img = Image.fromarray(_base_rgb(im_right))
    drw = ImageDraw.Draw(img)
    lxy = _to_np(left_xy_rot)
    rxy = _to_np(right_xy)
    dif = _to_np(diffs)
    v = np.ones(len(lxy), bool) if valid is None else _to_np(valid).astype(bool)
    for i in range(len(lxy)):
        if not v[i]:
            continue
        col = (0, 255, 0) if dif[i] <= threshold else (255, 0, 0)
        drw.line([tuple(lxy[i]), tuple(rxy[i])], fill=col, width=2)
    return np.asarray(img)


def save_image(arr, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(_to_np(arr).astype(np.uint8)).save(path)
