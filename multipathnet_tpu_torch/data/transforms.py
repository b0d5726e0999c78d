"""Device-side image preprocessing: normalize + aspect-preserving resize.

Port of multipathnet_tpu/data/transforms.py. The reference resizes with
`jax.image.scale_and_translate(..., method="linear")`, which antialiases
when it downscales: the triangle kernel is widened by 1/scale. That resize
is separable, so here it is two per-axis weight matrices (`_weight_mat`,
the same arithmetic as jax's `compute_weight_mat`) contracted with the
image in float32, followed by the reference's valid-extent mask.
"""

from __future__ import annotations

import torch

from multipathnet_tpu_torch.utils import profiling

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
# Caffe-origin trunks (the reference's converted VGG/ResNet .t7s): pixels in
# 0-255, BGR channel order, per-channel mean-pixel subtraction, no std.
# The Fast R-CNN-era PIXEL_MEANS, in BGR order.
CAFFE_BGR_MEAN = (102.9801, 115.9465, 122.7717)


def normalize(image_u8: torch.Tensor, preprocess: str = "rgb_unit"
              ) -> torch.Tensor:
    """(..., 3) uint8 RGB -> float32 normalized: [0, 1] RGB with ImageNet
    mean/std ("rgb_unit"), or BGR in 0-255 minus CAFFE_BGR_MEAN in
    float32, with no scale ("caffe_bgr")."""
    if preprocess == "caffe_bgr":
        x = image_u8.to(torch.float32).flip(-1)  # RGB -> BGR
        profiling.count_sync("normalize", x.device)
        return x - torch.tensor(CAFFE_BGR_MEAN, dtype=torch.float32,
                                device=x.device)
    if preprocess != "rgb_unit":
        raise ValueError(f"unknown preprocess {preprocess!r}")
    x = image_u8.to(torch.float32) / 255.0
    profiling.count_sync("normalize", x.device, 2)
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _weight_mat(input_size: int, output_size: int,
                scale: torch.Tensor) -> torch.Tensor:
    """Linear-resize weights for a batch of scales: scale (B,) float32 ->
    (B, output_size, input_size). Mirrors jax's compute_weight_mat with the
    triangle kernel, antialias on and zero translation."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None, None]              # (B, 1, 1)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=dev)
                 + 0.5)[None, :, None] * inv_scale - 0.5)  # (B, out, 1)
    cells = torch.arange(input_size, dtype=torch.float32, device=dev)
    x = torch.abs(sample_f - cells[None, None, :]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)   # (B, out, in)
    total = weights.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        torch.abs(total) > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def _resize(images_u8, canvas_hw, sh, sw, scale, preprocess):
    """images (B, H, W, 3) uint8; sh, sw, scale (B,) float32."""
    ch, cw = canvas_hw
    h, w = images_u8.shape[1:3]
    x = normalize(images_u8, preprocess)
    wy = _weight_mat(h, ch, scale)                        # (B, CH, H)
    wx = _weight_mat(w, cw, scale)                        # (B, CW, W)
    out = torch.einsum("bpy,byxc->bpxc", wy, x)
    out = torch.einsum("bqx,bpxc->bpqc", wx, out)
    # zero the region beyond the scaled extent
    yy = torch.arange(ch, dtype=torch.float32, device=x.device)
    xx = torch.arange(cw, dtype=torch.float32, device=x.device)
    valid = ((yy[None, :, None] < (sh * scale)[:, None, None])
             & (xx[None, None, :] < (sw * scale)[:, None, None]))
    return out * valid[..., None], scale


def batch_resize_to_canvas(images_u8: torch.Tensor, canvas_hw,
                           src_hws: torch.Tensor,
                           preprocess: str = "rgb_unit"):
    """images (B, H, W, 3) uint8 padded raw, src_hws (B, 2) valid (h, w) ->
    (canvases (B, CH, CW, 3) float32 normalized, scales (B,) float32).
    Boxes in source coords map to canvas coords by multiplying by scale."""
    src = src_hws.to(device=images_u8.device, dtype=torch.float32)
    sh, sw = src[:, 0], src[:, 1]
    return _resize(images_u8, canvas_hw, sh, sw,
                   canvas_scale(canvas_hw, sh, sw), preprocess)


def canvas_scale(canvas_hw, sh: torch.Tensor, sw: torch.Tensor
                 ) -> torch.Tensor:
    """min(ch / sh, cw / sw) for float32 source extents, each a true
    float32 division, as the reference's compiled jnp.minimum(ch / sh,
    cw / sw) computes it. (`int / tensor` in PyTorch is reciprocal(tensor)
    * int, two roundings, one float32 ulp above the quotient for some
    sizes: 48 / 30 gives 1.6000001 where the quotient rounds to 1.6.)"""
    ch, cw = canvas_hw
    return torch.minimum(torch.full_like(sh, ch) / sh,
                         torch.full_like(sw, cw) / sw)


def resize_to_canvas(image_u8: torch.Tensor, canvas_hw, src_hw=None,
                     preprocess: str = "rgb_unit"):
    """One (H, W, 3) image -> (canvas (CH, CW, 3), scale scalar). Without
    src_hw the scale is computed from the static shape in double precision
    and rounded once, as the reference does with Python floats."""
    if src_hw is not None:
        src = torch.as_tensor(src_hw, dtype=torch.float32).reshape(1, 2)
        canvas, scale = batch_resize_to_canvas(image_u8[None], canvas_hw,
                                               src, preprocess)
        return canvas[0], scale[0]
    (ch, cw), (h, w) = canvas_hw, image_u8.shape[:2]
    dev = image_u8.device
    profiling.count_sync("resize_scale", dev, 3)
    scale = torch.tensor([min(ch / h, cw / w)], dtype=torch.float32,
                         device=dev)
    sh = torch.tensor([float(h)], device=dev)
    sw = torch.tensor([float(w)], device=dev)
    canvas, scale = _resize(image_u8[None], canvas_hw, sh, sw, scale,
                            preprocess)
    return canvas[0], scale[0]
