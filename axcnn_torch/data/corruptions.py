"""ImageNet-C corruption generators — all 15 corruption types x severities 1-5.

The reference evaluates mCE on the *stored* ImageNet-C distribution
(reference:eval_imagenet_c protocol, SURVEY.md §3.4) and assumes the user
downloaded the ~75 GB tarballs. This module makes the robustness benchmark
self-contained: it regenerates the corruptions from clean images, following
the published algorithm definitions of Hendrycks & Dietrich, "Benchmarking
Neural Network Robustness to Common Corruptions and Perturbations" (ICLR
2019).  The per-severity parameter tables below are the paper's published
constants — like the AutoAugment policy tables, they ARE the benchmark
specification; the implementations around them are first-party
numpy/scipy/PIL re-derivations (upstream uses cv2 + scikit-image + ImageMagick
wand, none of which are available here).

Known deviations from the upstream generator (documented, [K-med] —
the upstream code is not mountable for bit-parity):

- ``motion_blur`` / ``snow``: upstream shells out to ImageMagick's
  one-sided gaussian motion blur; here the same one-sided gaussian line
  kernel is rasterized in numpy and applied with reflect padding.
- ``glass_blur``: upstream does sequential in-place pixel *swaps*; a
  sequential swap is a Python-loop disaster at 224^2 x 3 iterations, so this
  uses the standard vectorized gather approximation (each pixel *reads* a
  random nearby pixel per iteration) — same visual statistic, ~100x faster.
- ``frost``: upstream alpha-blends one of six bundled frost *photographs*;
  no image assets exist here, so a procedural frost texture (directionally
  blurred + thresholded plasma fractal crystals) stands in. The blend
  weights per severity are upstream's.
- ``elastic_transform`` keeps upstream's famous ``244``-instead-of-224
  size constants: they are part of the de-facto benchmark definition.

Every function takes ``img`` as HxWx3 uint8, ``severity`` in 1..5, and an
optional ``np.random.Generator`` (stochastic corruptions only), and returns
HxWx3 uint8. Deterministic given the rng.

The port's own copy of ``axcnn/data/corruptions.py``, unchanged, so that the port runs
without the JAX package installed: the same algorithms and the same draws
for the same ``np.random.Generator``.
"""

from __future__ import annotations

import io

import numpy as np
from PIL import Image
from scipy.ndimage import gaussian_filter, map_coordinates, zoom as sci_zoom

__all__ = ["CORRUPTION_FNS", "corrupt"]


def _to_float(img):
    return np.asarray(img, dtype=np.float32) / 255.0


def _to_uint8(x):
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _rng(rng):
    return rng if rng is not None else np.random.default_rng(0)


# --------------------------------------------------------------------------
# noise family
# --------------------------------------------------------------------------

def gaussian_noise(img, severity, rng=None):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = _to_float(img)
    return _to_uint8(x + _rng(rng).normal(size=x.shape, scale=c))


def shot_noise(img, severity, rng=None):
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _to_float(img)
    return _to_uint8(_rng(rng).poisson(x * c) / float(c))


def impulse_noise(img, severity, rng=None):
    """Salt & pepper: fraction c of pixels forced to 0 or 1 (per channel,
    matching skimage.util.random_noise(mode='s&p') semantics)."""
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    r = _rng(rng)
    x = _to_float(img).copy()
    flip = r.random(x.shape) < c
    salt = r.random(x.shape) < 0.5
    x[flip & salt] = 1.0
    x[flip & ~salt] = 0.0
    return _to_uint8(x)


# --------------------------------------------------------------------------
# blur family
# --------------------------------------------------------------------------

def _disk_kernel(radius, alias_blur=0.1):
    """Anti-aliased disk: hard disk indicator softened by a small gaussian."""
    L = np.arange(-max(8, radius), max(8, radius) + 1)
    X, Y = np.meshgrid(L, L)
    disk = ((X ** 2 + Y ** 2) <= radius ** 2).astype(np.float32)
    disk /= disk.sum()
    return gaussian_filter(disk, sigma=alias_blur)


def _conv2_channels(x, kernel):
    """Per-channel 2-D convolution with reflect padding via FFT-free scipy."""
    from scipy.ndimage import convolve

    return np.stack([convolve(x[..., ch], kernel, mode="reflect")
                     for ch in range(x.shape[-1])], axis=-1)


def defocus_blur(img, severity, rng=None):
    radius, alias = [(3, 0.1), (4, 0.5), (6, 0.5),
                     (8, 0.5), (10, 0.5)][severity - 1]
    x = _to_float(img)
    return _to_uint8(_conv2_channels(x, _disk_kernel(radius, alias)))


def glass_blur(img, severity, rng=None):
    sigma, max_delta, iters = [(0.7, 1, 2), (0.9, 2, 1), (1.0, 2, 3),
                               (1.1, 3, 2), (1.5, 4, 2)][severity - 1]
    r = _rng(rng)
    x = gaussian_filter(_to_float(img), sigma=(sigma, sigma, 0))
    h, w = x.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(iters):
        dy = r.integers(-max_delta, max_delta + 1, size=(h, w))
        dx = r.integers(-max_delta, max_delta + 1, size=(h, w))
        # vectorized gather (see module docstring: swap -> gather deviation)
        x = x[np.clip(yy + dy, 0, h - 1), np.clip(xx + dx, 0, w - 1)]
    return _to_uint8(gaussian_filter(x, sigma=(sigma, sigma, 0)))


def _motion_kernel(radius, sigma, angle_deg):
    """One-sided gaussian-weighted line kernel (ImageMagick-style motion
    blur, re-derived: weight_i = exp(-i^2 / (2 sigma^2)) along the angle)."""
    size = 2 * radius + 1
    k = np.zeros((size, size), dtype=np.float32)
    th = np.deg2rad(angle_deg)
    dyx = np.array([-np.sin(th), np.cos(th)])
    for i in range(radius + 1):
        y = radius + int(round(i * dyx[0]))
        x = radius + int(round(i * dyx[1]))
        k[y, x] += np.exp(-(i ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def motion_blur(img, severity, rng=None, *, angle_range=(-45.0, 45.0)):
    radius, sigma = [(10, 3), (15, 5), (15, 8),
                     (15, 12), (20, 15)][severity - 1]
    angle = _rng(rng).uniform(*angle_range)
    x = _to_float(img)
    return _to_uint8(_conv2_channels(x, _motion_kernel(radius, sigma, angle)))


def _clipped_zoom(x, factor):
    """Zoom into the center by ``factor`` keeping the spatial size."""
    h, w = x.shape[:2]
    ch, cw = int(np.ceil(h / factor)), int(np.ceil(w / factor))
    top, left = (h - ch) // 2, (w - cw) // 2
    z = sci_zoom(x[top:top + ch, left:left + cw],
                 (factor, factor) + (1,) * (x.ndim - 2), order=1)
    zt, zl = (z.shape[0] - h) // 2, (z.shape[1] - w) // 2
    return z[zt:zt + h, zl:zl + w]


def zoom_blur(img, severity, rng=None):
    factors = [np.arange(1, 1.11, 0.01), np.arange(1, 1.16, 0.01),
               np.arange(1, 1.21, 0.02), np.arange(1, 1.26, 0.02),
               np.arange(1, 1.31, 0.03)][severity - 1]
    x = _to_float(img)
    acc = x.copy()
    for f in factors:
        acc += _clipped_zoom(x, f)
    return _to_uint8(acc / (len(factors) + 1))


# --------------------------------------------------------------------------
# weather family
# --------------------------------------------------------------------------

def _plasma_fractal(mapsize, wibbledecay, r):
    """Diamond-square fractal heightmap in [0, 1]; mapsize power of two."""
    assert mapsize & (mapsize - 1) == 0, "mapsize must be a power of two"
    arr = np.zeros((mapsize, mapsize), dtype=np.float64)
    arr[0, 0] = 101
    stepsize, wibble = mapsize, 100.0

    def wibbled(shape):
        return r.uniform(-wibble, wibble, shape)

    while stepsize >= 2:
        half = stepsize // 2
        # diamond step: square centers from square corners
        corners = (arr[0:mapsize:stepsize, 0:mapsize:stepsize] +
                   np.roll(arr[0:mapsize:stepsize, 0:mapsize:stepsize], -1, 0) +
                   np.roll(arr[0:mapsize:stepsize, 0:mapsize:stepsize], -1, 1) +
                   np.roll(np.roll(arr[0:mapsize:stepsize,
                                       0:mapsize:stepsize], -1, 0), -1, 1))
        arr[half:mapsize:stepsize, half:mapsize:stepsize] = (
            corners / 4.0 + wibbled(corners.shape))
        # square step: edge midpoints from diamond centers + corners
        centers = arr[half:mapsize:stepsize, half:mapsize:stepsize]
        grid = arr[0:mapsize:stepsize, 0:mapsize:stepsize]
        ldr = (grid + np.roll(grid, -1, 0) + centers +
               np.roll(centers, 1, 1)) / 4.0
        arr[half:mapsize:stepsize, 0:mapsize:stepsize] = (
            ldr + wibbled(ldr.shape))
        tdr = (grid + np.roll(grid, -1, 1) + centers +
               np.roll(centers, 1, 0)) / 4.0
        arr[0:mapsize:stepsize, half:mapsize:stepsize] = (
            tdr + wibbled(tdr.shape))
        stepsize, wibble = half, wibble * wibbledecay
    arr -= arr.min()
    return arr / arr.max()


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def fog(img, severity, rng=None):
    c0, decay = [(1.5, 2.0), (2.0, 2.0), (2.5, 1.7),
                 (2.5, 1.5), (3.0, 1.4)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    fractal = _plasma_fractal(_next_pow2(max(h, w)), decay,
                              _rng(rng))[:h, :w]
    top = x.max()
    x = x + c0 * fractal[..., None]
    return _to_uint8(x * top / (top + c0))


def _frost_texture(h, w, r):
    """Procedural frost stand-in (see module docstring): crystalline streaks
    from a thresholded, directionally blurred plasma fractal."""
    full = _plasma_fractal(_next_pow2(max(h, w, 64)), 1.8, r)
    f = full[:h, :w]
    streaks = gaussian_filter(f, sigma=(0.5, 4.0))  # horizontal crystal grain
    streaks += gaussian_filter(full.T[:h, :w], sigma=(4.0, 0.5))
    streaks -= streaks.min()
    streaks /= max(streaks.max(), 1e-9)
    crystals = np.where(streaks > 0.55, streaks, 0.3 * streaks)
    return np.repeat(crystals[..., None], 3, axis=-1).astype(np.float32)


def frost(img, severity, rng=None):
    keep, add = [(1.0, 0.4), (0.8, 0.6), (0.7, 0.7),
                 (0.65, 0.7), (0.6, 0.75)][severity - 1]
    x = _to_float(img)
    tex = _frost_texture(x.shape[0], x.shape[1], _rng(rng))
    return _to_uint8(keep * x + add * tex)


def snow(img, severity, rng=None):
    loc, scale, zf, thresh, radius, sigma, keep = [
        (0.1, 0.3, 3.0, 0.5, 10, 4, 0.8),
        (0.2, 0.3, 2.0, 0.5, 12, 4, 0.7),
        (0.55, 0.3, 4.0, 0.9, 12, 8, 0.7),
        (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
        (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55)][severity - 1]
    r = _rng(rng)
    x = _to_float(img)
    h, w = x.shape[:2]
    layer = r.normal(loc=loc, scale=scale, size=(h, w, 1)).astype(np.float32)
    layer = _clipped_zoom(layer, zf)[..., 0]
    layer[layer < thresh] = 0.0
    kernel = _motion_kernel(radius, sigma, r.uniform(-135.0, -45.0))
    from scipy.ndimage import convolve

    layer = convolve(layer, kernel, mode="reflect")
    gray = (x @ np.array([0.299, 0.587, 0.114], dtype=np.float32))[..., None]
    x = keep * x + (1.0 - keep) * np.maximum(x, gray * 1.5 + 0.5)
    return _to_uint8(x + layer[..., None] + np.rot90(layer, 2)[..., None])


# --------------------------------------------------------------------------
# digital family
# --------------------------------------------------------------------------

def brightness(img, severity, rng=None):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    x = _to_float(img)
    # add c to HSV value = add c to each channel scaled so hue/sat hold;
    # upstream adds to the V channel, equivalent to scaling towards white on
    # the max channel — implement the exact rgb->hsv->rgb round-trip
    mx, mn = x.max(-1, keepdims=True), x.min(-1, keepdims=True)
    v = np.clip(mx + c, 0.0, 1.0)
    scale = np.where(mx > 0, v / np.maximum(mx, 1e-12), 0.0)
    return _to_uint8(np.where(mx > 0, x * scale, v))


def contrast(img, severity, rng=None):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = _to_float(img)
    means = x.mean(axis=(0, 1), keepdims=True)
    return _to_uint8((x - means) * c + means)


def elastic_transform(img, severity, rng=None):
    # (alpha, sigma, alpha_affine) — upstream's published constants, incl.
    # the 244-for-224 typo that became part of the benchmark definition
    alpha, sigma, alpha_affine = [
        (244 * 2, 244 * 0.7, 244 * 0.1),
        (244 * 2, 244 * 0.08, 244 * 0.2),
        (244 * 0.05, 244 * 0.01, 244 * 0.02),
        (244 * 0.07, 244 * 0.01, 244 * 0.02),
        (244 * 0.12, 244 * 0.01, 244 * 0.04)][severity - 1]
    r = _rng(rng)
    x = _to_float(img)
    h, w = x.shape[:2]

    # random 3-point affine: perturb an equilateral anchor triangle
    center = np.float32([h, w]) // 2
    sq = min(h, w) // 3
    pts1 = np.float32([center + sq, [center[0] + sq, center[1] - sq],
                       center - sq])
    pts2 = pts1 + r.uniform(-alpha_affine, alpha_affine,
                            size=pts1.shape).astype(np.float32)
    # solve [x y 1] @ M = x' for the 2x3 affine (cv2.getAffineTransform equiv)
    A = np.hstack([pts1, np.ones((3, 1), dtype=np.float32)])
    M = np.linalg.solve(A, pts2)  # 3x2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    src = np.stack([yy, xx, np.ones_like(yy)], axis=-1) @ M
    x = np.stack([map_coordinates(x[..., ch], [src[..., 0], src[..., 1]],
                                  order=1, mode="reflect")
                  for ch in range(3)], axis=-1)

    # gaussian-smoothed random displacement field
    dx = gaussian_filter(r.uniform(-1, 1, (h, w)), sigma,
                         mode="reflect") * alpha
    dy = gaussian_filter(r.uniform(-1, 1, (h, w)), sigma,
                         mode="reflect") * alpha
    coords = [yy + dy, xx + dx]
    out = np.stack([map_coordinates(x[..., ch], coords, order=1,
                                    mode="reflect") for ch in range(3)],
                   axis=-1)
    return _to_uint8(out)


def pixelate(img, severity, rng=None):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    im = Image.fromarray(np.asarray(img, dtype=np.uint8))
    w, h = im.size
    small = im.resize((max(1, int(w * c)), max(1, int(h * c))), Image.BOX)
    return np.asarray(small.resize((w, h), Image.BOX))


def jpeg_compression(img, severity, rng=None):
    c = [25, 18, 15, 10, 7][severity - 1]
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, dtype=np.uint8)).save(
        buf, "JPEG", quality=c)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))


# --------------------------------------------------------------------------

CORRUPTION_FNS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
}


def corrupt(img, name: str, severity: int, rng=None) -> np.ndarray:
    """Apply corruption ``name`` at ``severity`` (1..5) to HxWx3 uint8."""
    if name not in CORRUPTION_FNS:
        raise ValueError(f"unknown corruption {name!r}; "
                         f"choose from {sorted(CORRUPTION_FNS)}")
    if not 1 <= severity <= 5:
        raise ValueError(f"severity must be in 1..5, got {severity}")
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected HxWx3 uint8, got {img.shape} {img.dtype}")
    return CORRUPTION_FNS[name](img, severity, rng)
