"""AutoAugment on the device (port of ``axcnn/data/autoaugment_device.py``).

The policy runs on the batch where it lives, on fp32 NHWC images in
[0, 255], right before normalization in the train step, so the host loader
only decodes and crops. The op formulas are the reference's (its TF
lineage): geometric ops are inverse-affine warps with clipped-index bilinear
gathers, the validity window [-0.5, w - 0.5] and a fill of 128; the enhance
ops blend towards a degenerate image and clip; Sharpness smooths with PIL's
SMOOTH kernel and keeps the border pixels; Posterize, Solarize and
SolarizeAdd cast their levels to integers; Equalize builds the TF LUT.
Where the reference's form was shaped for the TPU, the port takes the torch
idiom: Equalize's histogram is one ``scatter_add_`` over every (image,
channel, level) and its LUT one gather (the reference sweeps 256 compares
and 256 masked adds), and the affine warp gathers each corner with one
``index_select``.

The applicator keeps the reference's structure: the batch splits into
``num_groups`` groups (1 when the batch does not divide), each group draws
one sub-policy, then per image two apply-coins and two signs. The draws are
made on the host, from the step's numpy stream (``draw_autoaugment``), as
mixup's lambda is, and Python calls only the selected op, on only the images
whose coin came up: the counterpart of the reference's ``lax.switch`` and
``where``, with nothing on the host waiting for the device. The geometry
(each image's warp matrix) is computed on the host in float32, in the
reference's order, and copied over with the indices of the selected images.
``draws=`` replaces the random draws (a test hands in the reference's).
``rows=`` places the batch inside a larger one (a data shard of the global
batch under spatial partitioning): the groups and the draws are then the
larger batch's, and each image takes its own.

Cutout is the reference's stand-in: a centred square (the v0 and imagenet
policies do not use it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from axcnn_torch.data.autoaugment import _MAX_LEVEL, POLICIES

_FILL = 128.0
_F32 = np.float32


def _level(mag, scale) -> np.float32:
    """``mag / _MAX_LEVEL * scale`` in float32, as the reference's traced
    arithmetic on its float32 magnitude."""
    return _F32(mag) / _F32(_MAX_LEVEL) * _F32(scale)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # from pinned memory the copy queues on the stream, and the host
        # does not wait for the work ahead of it
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# geometric ops: inverse affine warp, bilinear, gray fill
# ---------------------------------------------------------------------------

def affine_warp(imgs: torch.Tensor, mats: np.ndarray) -> torch.Tensor:
    """``imgs`` (G, H, W, C) fp32; ``mats`` (G, 2, 3) float32, the inverse
    transforms [[a, b, c], [d, e, f]] mapping an OUTPUT (x, y) to SOURCE
    coordinates (x the column, y the row)."""
    g, h, w, c = imgs.shape
    m = _to_device(mats.astype(_F32), imgs.device).view(g, 6, 1, 1)
    ys = torch.arange(h, dtype=torch.float32, device=imgs.device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=imgs.device).view(1, 1, w)
    sx = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    sy = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = imgs.reshape(g * h * w, c)
    base = torch.arange(g, device=imgs.device).view(g, 1, 1) * (h * w)

    def gather(yc, xc):
        yi = torch.clamp(yc, 0, h - 1).to(torch.int64)
        xi = torch.clamp(xc, 0, w - 1).to(torch.int64)
        return flat.index_select(0, (base + yi * w + xi).view(-1)).view(g, h, w, c)

    p00, p01 = gather(y0, x0), gather(y0, x0 + 1)
    p10, p11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    valid = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    return torch.where(valid[..., None], out, _FILL)


def _shift_mats(signs, scale, mag, at):
    """Identity matrices plus ``v = level * sign`` at ``at`` (row, col)."""
    mats = np.tile(np.array([[1, 0, 0], [0, 1, 0]], _F32), (len(signs), 1, 1))
    mats[:, at[0], at[1]] += _level(mag, scale) * signs.astype(_F32)
    return mats


def _shear_x(imgs, mag, signs):
    return affine_warp(imgs, _shift_mats(signs, 0.3, mag, (0, 1)))


def _shear_y(imgs, mag, signs):
    return affine_warp(imgs, _shift_mats(signs, 0.3, mag, (1, 0)))


def _translate_x(imgs, mag, signs):
    return affine_warp(imgs, _shift_mats(signs, 100.0, mag, (0, 2)))


def _translate_y(imgs, mag, signs):
    return affine_warp(imgs, _shift_mats(signs, 100.0, mag, (1, 2)))


def _rotate(imgs, mag, signs):
    # rotate around the image centre by -deg (PIL rotates CCW; inverse map)
    h, w = imgs.shape[1:3]
    deg = _level(mag, 30.0) * signs.astype(_F32)
    rad = deg * _F32(3.14159265358979 / 180.0)
    cx, cy = _F32((w - 1) / 2.0), _F32((h - 1) / 2.0)
    cos, sin = np.cos(rad), np.sin(rad)
    mats = np.stack([np.stack([cos, -sin, cx - cos * cx + sin * cy], -1),
                     np.stack([sin, cos, cy - sin * cx - cos * cy], -1)], 1)
    return affine_warp(imgs, mats)


# ---------------------------------------------------------------------------
# colour ops
# ---------------------------------------------------------------------------

def _blend(a, b, factor):
    """factor 0 -> a, 1 -> b; extrapolates beyond 1 (PIL ImageEnhance)."""
    return torch.clamp(a + (b - a) * factor, 0.0, 255.0)


def _enh_factor(mag) -> float:
    return float(_level(mag, 1.8) + _F32(0.1))


def _grayscale(imgs):
    # PIL L-mode weights
    g = imgs[..., 0] * 0.299 + imgs[..., 1] * 0.587 + imgs[..., 2] * 0.114
    return g[..., None].expand(imgs.shape)


def _color(imgs, mag, signs):
    return _blend(_grayscale(imgs), imgs, _enh_factor(mag))


def _contrast(imgs, mag, signs):
    # blend with the mean of each image's grayscale
    mean = _grayscale(imgs)[..., 0].mean(dim=(1, 2))
    return _blend(mean.view(-1, 1, 1, 1).expand(imgs.shape), imgs, _enh_factor(mag))


def _brightness(imgs, mag, signs):
    return _blend(torch.zeros_like(imgs), imgs, _enh_factor(mag))


_SMOOTH = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], _F32) / _F32(13.0)


def _sharpness(imgs, mag, signs):
    # PIL SMOOTH kernel [[1,1,1],[1,5,1],[1,1,1]]/13 as nine shifted adds
    # (no conv, so no cuDNN or TF32 choice); border pixels kept
    h, w = imgs.shape[1:3]
    xp = F.pad(imgs, (0, 0, 1, 1, 1, 1))
    smooth = None
    for i in range(3):
        for j in range(3):
            term = xp[:, i:i + h, j:j + w] * float(_SMOOTH[i, j])
            smooth = term if smooth is None else smooth + term
    interior = torch.zeros((1, h, w, 1), dtype=torch.bool, device=imgs.device)
    interior[:, 1:h - 1, 1:w - 1] = True
    return _blend(torch.where(interior, smooth, imgs), imgs, _enh_factor(mag))


def _posterize(imgs, mag, signs):
    shift = int(_level(mag, 4.0).astype(np.int32))  # 8 - bits, bits = 8 - level
    iv = imgs.to(torch.int32)
    return ((iv >> shift) << shift).to(torch.float32)


def _solarize(imgs, mag, signs):
    threshold = 256.0 - float(_level(mag, 256.0).astype(np.int32))
    return torch.where(imgs >= threshold, 255.0 - imgs, imgs)


def _solarize_add(imgs, mag, signs):
    add = float(_level(mag, 110.0).astype(np.int32))
    return torch.where(imgs < 128.0, torch.clamp(imgs + add, 0.0, 255.0), imgs)


def _autocontrast(imgs, mag, signs):
    lo = imgs.amin(dim=(1, 2), keepdim=True)
    hi = imgs.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / torch.clamp_min(hi - lo, 1e-6), 1.0)
    off = torch.where(hi > lo, -lo * scale, 0.0)
    return torch.clamp(imgs * scale + off, 0.0, 255.0)


def equalize(imgs: torch.Tensor) -> torch.Tensor:
    """Histogram equalization per image and channel, the TF-reference LUT,
    on (G, H, W, C) fp32; exact integer arithmetic throughout."""
    g, h, w, c = imgs.shape
    levels = torch.arange(256, device=imgs.device)
    iv = torch.clamp(imgs, 0, 255).to(torch.int64)
    # one bin per (image, channel, level)
    key = torch.arange(g * c, device=imgs.device).view(g, 1, 1, c) * 256 + iv
    histo = torch.zeros(g * c * 256, dtype=torch.int64, device=imgs.device)
    histo.scatter_add_(0, key.view(-1), torch.ones_like(key).view(-1))
    histo = histo.view(g, c, 256)
    cum = histo.cumsum(-1)
    # TF reference: step = (total - last nonzero count) // 255
    nz_idx = torch.where(histo > 0, levels, 0).amax(-1, keepdim=True)
    last = histo.gather(-1, nz_idx)
    step = (cum[..., -1:] - last) // 255
    lut = (cum + step // 2) // torch.clamp_min(step, 1)
    lut = torch.clamp(F.pad(lut[..., :-1], (1, 0)), 0, 255)
    lut = torch.where(step == 0, levels, lut)
    return lut.view(-1)[key].to(torch.float32)


def _equalize(imgs, mag, signs):
    return equalize(imgs)


def _invert(imgs, mag, signs):
    return 255.0 - imgs


def _cutout(imgs, mag, signs):
    # the reference's stand-in: a centred square of half-side level * 40
    size = int(_level(mag, 40.0).astype(np.int32))
    h, w = imgs.shape[1:3]
    cy, cx = h // 2, w // 2
    out = imgs.clone()
    out[:, max(cy - size, 0):cy + size, max(cx - size, 0):cx + size] = _FILL
    return out


# each op: (imgs (G, H, W, C) fp32, magnitude, per-image signs (G,) numpy)
OP_FNS = {
    "ShearX": _shear_x, "ShearY": _shear_y,
    "TranslateX": _translate_x, "TranslateY": _translate_y,
    "Rotate": _rotate, "Color": _color, "Contrast": _contrast,
    "Brightness": _brightness, "Sharpness": _sharpness,
    "Posterize": _posterize, "Solarize": _solarize,
    "SolarizeAdd": _solarize_add, "AutoContrast": _autocontrast,
    "Equalize": _equalize, "Invert": _invert, "Cutout": _cutout,
}


def num_groups_for(batch: int, num_groups: int) -> int:
    return num_groups if batch % num_groups == 0 else 1


def draw_autoaugment(rng: np.random.Generator, num_sub: int, groups: int, group_size: int):
    """One entry per group: (sub-policy index, apply-coins (2, m) float32,
    signs (2, m) float32 of +-1)."""
    draws = []
    for _ in range(groups):
        sub = int(rng.integers(0, num_sub))
        coins = rng.random((2, group_size), dtype=_F32)
        signs = np.where(rng.random((2, group_size), dtype=_F32) < 0.5, -1.0, 1.0).astype(_F32)
        draws.append((sub, coins, signs))
    return draws


def make_device_autoaugment(policy_name: str = "v0", *, num_groups: int = 8):
    """``fn(images_u8 NHWC, rng=None, *, draws=None, rows=None) -> fp32 NHWC
    in [0, 255]`` on the images' device, or None for ``'none'``. ``rng`` (a
    numpy Generator) makes the draws unless ``draws`` (``draw_autoaugment``'s
    form, one entry per group) is given. ``rows = (start, total)``: the
    images are rows ``[start, start + n)`` of a batch of ``total`` (a data
    shard of the global batch under spatial partitioning); the groups and
    the draws are then that batch's, and each image takes its own."""
    if policy_name in (None, "", "none"):
        return None
    try:
        policy = POLICIES[policy_name]
    except KeyError:
        raise ValueError(f"unknown autoaugment_type {policy_name!r}; known: "
                         f"{sorted(POLICIES)} or 'none'") from None

    def fn(images_u8: torch.Tensor, rng: np.random.Generator | None = None, *, draws=None,
           rows=None):
        n = images_u8.shape[0]
        start, total = (0, n) if rows is None else rows
        g = num_groups_for(total, num_groups)
        m = total // g
        if draws is None:
            draws = draw_autoaugment(rng, len(policy), g, m)
        if len(draws) != g:
            raise ValueError(f"{len(draws)} AutoAugment draws for {g} groups")
        images = images_u8.to(torch.float32)
        for k, (sub, coins, signs) in enumerate(draws):
            # the group's images [k*m, (k+1)*m) that lie in [start, start + n)
            lo, hi = max(k * m, start), min((k + 1) * m, start + n)
            if lo >= hi:
                continue
            part = slice(lo - k * m, hi - k * m)
            for j, (name, prob, mag) in enumerate(policy[sub]):
                chosen = np.flatnonzero(coins[j][part] < _F32(prob))
                if chosen.size == 0:
                    continue
                idx = _to_device(lo - start + chosen, images.device)
                out = OP_FNS[name](images.index_select(0, idx), mag, signs[j][part][chosen])
                images.index_copy_(0, idx, out)
        return images

    return fn
