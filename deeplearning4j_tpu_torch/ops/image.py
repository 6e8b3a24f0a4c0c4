"""Image ops: resize, crop_and_resize, NMS, color-space conversions,
samplers (counterpart of deeplearning4j_tpu/ops/image.py).

NHWC unless an op says NCHW. Resizing is ``jax.image.resize``'s, not
``F.interpolate``'s: pixel centres at half-integers, a triangle (bilinear)
or Keys cubic (a = -0.5) kernel whose support widens by the scale factor
when it shrinks (antialiasing), the weights of each output pixel
normalized to sum to one, and nearest-neighbour reading input
floor((i + 0.5) * in / out). The weight matrices are built here and
applied as two contractions. ``crop_and_resize`` samples as
``map_coordinates`` with a zero outside the image. NMS returns a fixed
number of indices padded with -1, as the reference's static shape does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


def _triangle(x):
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _keys_cubic(x):
    x = x.abs()
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                      ((1.5 * x - 2.5) * x) * x + 1.0)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def resize_weights(in_size: int, out_size: int, kernel, device=None):
    """The (in, out) weight matrix of jax.image's scale_and_translate for
    one axis, antialiased, in fp32."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kscale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x, size, method):
    x = C.t(x)
    oh, ow = int(size[0]), int(size[1])
    h, w = x.shape[1], x.shape[2]
    if method == "nearest":
        out = x
        if oh != h:
            iy = torch.floor((torch.arange(oh, dtype=torch.float32) + 0.5)
                             * h / oh).long().to(x.device)
            out = out[:, iy]
        if ow != w:
            ix = torch.floor((torch.arange(ow, dtype=torch.float32) + 0.5)
                             * w / ow).long().to(x.device)
            out = out[:, :, ix]
        return out
    kernel = {"bilinear": _triangle, "linear": _triangle,
              "cubic": _keys_cubic}[method]
    xf = x.float()
    if oh != h:
        xf = torch.einsum("bhwc,ho->bowc", xf,
                          resize_weights(h, oh, kernel, x.device))
    if ow != w:
        xf = torch.einsum("bhwc,wo->bhoc", xf,
                          resize_weights(w, ow, kernel, x.device))
    return xf.to(x.dtype)


@op("image_resize", "image")
def image_resize(x, size, method="bilinear"):
    """tf.image.resize parity; method: bilinear | nearest | cubic."""
    return _resize(x, size, {"bicubic": "cubic"}.get(method, method))


@op("resize_bilinear", "image", aliases=("resizebilinear",))
def resize_bilinear(x, size=None, height=None, width=None):
    return _resize(x, size or (height, width), "bilinear")


@op("resize_nearest", "image",
    aliases=("resizenearest", "resize_nearest_neighbor"))
def resize_nearest(x, size=None, height=None, width=None):
    return _resize(x, size or (height, width), "nearest")


@op("resize_bicubic", "image", aliases=("resizebicubic",))
def resize_bicubic(x, size=None, height=None, width=None):
    return _resize(x, size or (height, width), "cubic")


def _map_coords(img, gy, gx, order):
    """map_coordinates on one (H, W, C) image at float coordinates, mode
    constant 0: order 1 blends the four neighbours, order 0 takes the
    nearest (half away from zero); a neighbour outside reads 0."""
    h, w = img.shape[0], img.shape[1]

    def read(iy, ix):
        ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return v * ok[..., None].to(v.dtype)

    if order == 0:
        ry = torch.sign(gy) * torch.floor(gy.abs() + 0.5)
        rx = torch.sign(gx) * torch.floor(gx.abs() + 0.5)
        return read(ry.long(), rx.long())
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy, wx = gy - y0, gx - x0
    y0, x0 = y0.long(), x0.long()
    return (read(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
            + read(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
            + read(y0 + 1, x0) * (wy * (1 - wx))[..., None]
            + read(y0 + 1, x0 + 1) * (wy * wx)[..., None])


@op("crop_and_resize", "image")
def crop_and_resize(image, boxes, box_indices, crop_size, method="bilinear"):
    """Normalized [y1,x1,y2,x2] boxes over a batch: image (B,H,W,C), boxes
    (N,4), box_indices (N,) -> (N, ch, cw, C)."""
    h, w = image.shape[1], image.shape[2]
    ch, cw = int(crop_size[0]), int(crop_size[1])
    order = 1 if method == "bilinear" else 0
    boxes = C.t(boxes, image).float()
    idx = C.t(box_indices, image).long()
    out = []
    ry = torch.arange(ch, dtype=torch.float32, device=image.device) / max(
        ch - 1, 1)
    rx = torch.arange(cw, dtype=torch.float32, device=image.device) / max(
        cw - 1, 1)
    for n in range(boxes.shape[0]):
        y1, x1, y2, x2 = boxes[n]
        ys = y1 * (h - 1) + ry * (y2 - y1) * (h - 1)
        xs = x1 * (w - 1) + rx * (x2 - x1) * (w - 1)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(_map_coords(image[idx[n]].float(), gy, gx, order))
    return torch.stack(out).to(image.dtype)


@op("extract_image_patches", "image")
def extract_image_patches(x, ksizes, strides=(1, 1), rates=(1, 1),
                          padding="VALID"):
    """(B,H,W,C) -> (B,oh,ow,kh*kw*C), features in (kh, kw, C) order."""
    kh, kw = ksizes
    b, h, w, c = x.shape
    if padding == "SAME":
        from deeplearning4j_tpu_torch.ops.nn import _same_pads
        (pt, pb), (pl, pr) = (_same_pads(h, kh, strides[0], rates[0]),
                              _same_pads(w, kw, strides[1], rates[1]))
    else:
        pt = pb = pl = pr = 0
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    oh = (xc.shape[2] - (kh - 1) * rates[0] - 1) // strides[0] + 1
    ow = (xc.shape[3] - (kw - 1) * rates[1] - 1) // strides[1] + 1
    cols = F.unfold(xc, (kh, kw), dilation=tuple(rates),
                    stride=tuple(strides))                 # (B, C*kh*kw, L)
    cols = cols.reshape(b, c, kh * kw, oh, ow).permute(0, 3, 4, 2, 1)
    return cols.reshape(b, oh, ow, kh * kw * c)


def _iou_matrix(boxes):
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    inter = torch.clamp_min(iy2 - iy1, 0) * torch.clamp_min(ix2 - ix1, 0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


@op("non_max_suppression", "image", aliases=("nms",))
def non_max_suppression(boxes, scores, max_output_size, iou_threshold=0.5,
                        score_threshold=-float("inf")):
    """Greedy NMS -> (max_output_size,) int32 indices padded with -1."""
    boxes = C.t(boxes).float()
    scores = C.t(scores, boxes).float()
    iou = _iou_matrix(boxes)
    m = int(max_output_size)
    alive = scores >= score_threshold
    sel = torch.full((m,), -1, dtype=torch.int32, device=boxes.device)
    count = 0
    for _ in range(m):
        s = torch.where(alive, scores, torch.full_like(scores,
                                                       float("-inf")))
        best = int(torch.argmax(s))
        if not bool(torch.isfinite(s[best])):
            break
        sel[count] = best
        count += 1
        alive = alive & (iou[best] <= iou_threshold)
        alive[best] = False
    return sel


@op("rgb_to_grayscale", "image", aliases=("rgb_to_grs",))
def rgb_to_grayscale(x):
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1, keepdim=True)


_YUV = [[0.299, -0.14714119, 0.61497538],
        [0.587, -0.28886916, -0.51496512],
        [0.114, 0.43601035, -0.10001026]]
_RGB = [[1.0, 1.0, 1.0], [0.0, -0.394642334, 2.03206185],
        [1.13988303, -0.58062185, 0.0]]


@op("rgb_to_yuv", "image")
def rgb_to_yuv(x):
    m = torch.tensor(_YUV, dtype=torch.float32, device=x.device)
    return (x.float() @ m).to(x.dtype)


@op("yuv_to_rgb", "image")
def yuv_to_rgb(x):
    m = torch.tensor(_RGB, dtype=torch.float32, device=x.device)
    return (x.float() @ m).to(x.dtype)


@op("rgb_to_hsv", "image")
def rgb_to_hsv(x):
    xf = x.float()
    r, g, b = xf[..., 0], xf[..., 1], xf[..., 2]
    mx, mn = xf.amax(dim=-1), xf.amin(dim=-1)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0)) / 6.0
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-1).to(x.dtype)


@op("hsv_to_rgb", "image")
def hsv_to_rgb(x):
    xf = x.float()
    h, s, v = xf[..., 0] * 6.0, xf[..., 1], xf[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1).to(x.dtype)


@op("adjust_brightness", "image")
def adjust_brightness(x, delta):
    return x + torch.as_tensor(delta, dtype=x.dtype, device=x.device)


@op("adjust_contrast", "image", aliases=("adjust_contrast_v2",))
def adjust_contrast(x, factor):
    xf = x.float()
    mean = xf.mean(dim=(-3, -2), keepdim=True)
    return (factor * (xf - mean) + mean).to(x.dtype)


@op("adjust_saturation", "image")
def adjust_saturation(x, factor):
    hsv = rgb_to_hsv(x)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


@op("adjust_hue", "image")
def adjust_hue(x, delta):
    hsv = rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


@op("flip_left_right", "image", aliases=("image_flip_left_right",))
def flip_left_right(x):
    return torch.flip(x, (-2,))


@op("flip_up_down", "image", aliases=("image_flip_up_down",))
def flip_up_down(x):
    return torch.flip(x, (-3,))


@op("random_crop", "image")
def random_crop(gen, x, size):
    """Random spatial crop of (B,H,W,C) or (H,W,C) to ``size`` (h, w), the
    offsets drawn from ``gen`` (a torch.Generator, in the key's place)."""
    h, w = int(size[0]), int(size[1])
    hax, wax = (1, 2) if x.dim() == 4 else (0, 1)
    oy = int(torch.randint(0, x.shape[hax] - h + 1, (), generator=gen,
                           device=gen.device))
    ox = int(torch.randint(0, x.shape[wax] - w + 1, (), generator=gen,
                           device=gen.device))
    return x.narrow(hax, oy, h).narrow(wax, ox, w)


@op("ssim", "image", differentiable=False)
def ssim(a, b, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01,
         k2=0.03):
    """Structural similarity, tf.image.ssim semantics: NHWC, an 11x11
    Gaussian window of sigma 1.5 (VALID), per-image mean over space and
    channels."""
    r = torch.arange(filter_size, dtype=torch.float32,
                     device=a.device) - (filter_size - 1) / 2.0
    g = torch.exp(-(r ** 2) / (2.0 * filter_sigma ** 2))
    g = g / g.sum()
    c = a.shape[-1]
    win = torch.outer(g, g)[None, None].expand(c, 1, filter_size,
                                              filter_size)

    def filt(v):
        return F.conv2d(v.float().permute(0, 3, 1, 2), win,
                        groups=c).permute(0, 2, 3, 1)

    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    mu_a, mu_b = filt(a), filt(b)
    va = filt(a * a) - mu_a * mu_a
    vb = filt(b * b) - mu_b * mu_b
    cov = filt(a * b) - mu_a * mu_b
    lum = (2.0 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2.0 * cov + c2) / (va + vb + c2)
    return (lum * cs).mean(dim=(1, 2, 3))


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _sample_bilinear_nchw(img, px, py, padding_mode):
    """img (C, H, W); px/py pixel coordinates (...). Returns (C, ...)."""
    _, h, w = img.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            weight = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
            val = img[:, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
            if padding_mode == "zeros":
                inb = ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                       & (yi <= h - 1)).to(img.dtype)
                weight = weight * inb
            out = out + val * weight.to(img.dtype)
    return out


@op("grid_sample", "image")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False):
    """F.grid_sample / ONNX GridSample semantics, written out as the
    reference writes them: x (N, C, H, W); grid (N, Ho, Wo, 2) normalized
    (x, y). Returns (N, C, Ho, Wo)."""
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(f"padding_mode {padding_mode!r}")
    h, w = x.shape[2], x.shape[3]
    px = _unnormalize(grid[..., 0], w, align_corners)
    py = _unnormalize(grid[..., 1], h, align_corners)
    outs = []
    for n in range(x.shape[0]):
        img, gx, gy = x[n], px[n], py[n]
        if mode == "nearest":
            xi, yi = torch.round(gx), torch.round(gy)
            val = img[:, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
            if padding_mode == "zeros":
                val = val * ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                             & (yi <= h - 1)).to(img.dtype)
            outs.append(val)
        elif mode == "bilinear":
            outs.append(_sample_bilinear_nchw(img, gx, gy, padding_mode))
        else:
            raise NotImplementedError(f"grid_sample mode {mode!r}")
    return torch.stack(outs)


@op("roi_align", "image")
def roi_align(x, boxes, batch_indices, output_size=(7, 7), spatial_scale=1.0,
              sampling_ratio=2, mode="avg", aligned=True):
    """torchvision roi_align / ONNX RoiAlign: x (N, C, H, W); boxes (K, 4)
    as (x1, y1, x2, y2); a positive ``sampling_ratio``. Returns
    (K, C, oh, ow)."""
    if int(sampling_ratio) <= 0:
        raise NotImplementedError(
            "roi_align adaptive sampling_ratio<=0 is data-dependent; "
            "pass an explicit positive ratio")
    boxes = C.t(boxes, x).float()
    bidx = C.t(batch_indices, x).long()
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else tuple(output_size))
    r = int(sampling_ratio)
    off = 0.5 if aligned else 0.0
    ar = (torch.arange(r, dtype=torch.float32, device=x.device) + 0.5) / r
    outs = []
    for k in range(boxes.shape[0]):
        img = x[bidx[k]]
        x1, y1, x2, y2 = boxes[k] * spatial_scale - off
        rw, rh = x2 - x1, y2 - y1
        if not aligned:
            rw, rh = torch.clamp_min(rw, 1.0), torch.clamp_min(rh, 1.0)
        bh, bw = rh / oh, rw / ow
        gy = y1 + bh * (torch.arange(oh, device=x.device)[:, None] + ar[None])
        gx = x1 + bw * (torch.arange(ow, device=x.device)[:, None] + ar[None])
        py = gy.reshape(-1)[:, None].expand(oh * r, ow * r)
        px = gx.reshape(-1)[None, :].expand(oh * r, ow * r)
        vals = _sample_bilinear_nchw(img, px, py, "border").reshape(
            img.shape[0], oh, r, ow, r)
        outs.append(vals.amax(dim=(2, 4)) if mode == "max"
                    else vals.mean(dim=(2, 4)))
    return torch.stack(outs)
