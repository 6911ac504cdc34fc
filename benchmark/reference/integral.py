"""Integral images and box sums — the substrate for SURF's box-filter
Hessians and Haar wavelets.

Counterpart of spherical_bundle_adjuster_tpu/ops/integral.py. Every
function takes an optional leading batch of bands. Box sums at static
offsets are four shifted (optionally strided) views of an edge-padded
integral image (surf_maps.py sums its boxes with them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rgb_to_gray(image):
    """(H, W, 3) uint8/float -> (H, W) float32 luma (OpenCV's RGB2GRAY
    weights). An (H, W) input is returned as float32."""
    img = image.to(torch.float32)
    if img.ndim == 2:
        return img
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


# Row stride of an integral image in floats: a multiple of 4, so that every
# row starts 16-byte aligned (the CUDA kernels stage rows with 16-byte
# copies).
ROW_ALIGN = 4


def integral_image(gray):
    """(..., H, W) -> (..., H+1, W+1) exclusive-prefix integral image.

    ii[y, x] = sum of gray[:y, :x]; ii[0, :] = ii[:, 0] = 0. The result is
    a view whose rows are padded in memory to a multiple of ROW_ALIGN
    floats (is_row_aligned). Both prefix sums accumulate in float64 and
    the result is rounded once to float32, so every entry is within half
    an ulp of the exact sum on any device (a float32 scan's error grows
    with the band and depends on the device's summation order).
    """
    ii = torch.cumsum(torch.cumsum(gray.to(torch.float64), dim=-2), dim=-1)
    *lead, h, w = ii.shape
    ld = -(-(w + 1) // ROW_ALIGN) * ROW_ALIGN
    out = torch.zeros((*lead, h + 1, ld), dtype=torch.float32, device=ii.device)
    out[..., 1:, 1 : w + 1] = ii
    return out[..., : w + 1]


def is_row_aligned(ii) -> bool:
    """Whether (B, H+1, W+1) ii has integral_image's layout: unit column
    stride, a row stride that is a multiple of ROW_ALIGN, bands one after
    the other, and a 16-byte aligned start."""
    ld = ii.stride(1)
    return (ii.stride(2) == 1 and ld >= ii.shape[2] and ld % ROW_ALIGN == 0
            and ii.stride(0) == ii.shape[1] * ld and ii.data_ptr() % 16 == 0)


def edge_pad(ii, pad):
    """Edge-replicate `pad` pixels on all four sides of (B, H, W)."""
    return F.pad(ii[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]


def shifted_box_sums(ii, boxes, out_h, out_w, step=1):
    """Dense box sums at every pixel for a list of static boxes.

    ii: (..., H+1, W+1) integral image, large enough for every offset.
    boxes: list of (y0, x0, y1, x1, weight); the box for output pixel
      (y, x) spans rows [y*step + y0, y*step + y1) and cols
      [x*step + x0, x*step + x1).
    Returns (..., out_h, out_w), the weighted sum in list order.
    """
    def sl(dy, dx):
        return ii[
            ...,
            dy : dy + (out_h - 1) * step + 1 : step,
            dx : dx + (out_w - 1) * step + 1 : step,
        ]

    acc = None
    for (y0, x0, y1, x1, w) in boxes:
        s = sl(y1, x1) - sl(y0, x1) - sl(y1, x0) + sl(y0, x0)
        term = w * s
        acc = term if acc is None else acc + term
    return acc
