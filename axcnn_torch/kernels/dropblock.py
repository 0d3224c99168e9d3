"""DropBlock: the CUDA kernels' wrappers, their plain versions, and the
``torch.autograd.Function``s of the apply and of the fused kernel.

The kernels (``axcnn_torch/csrc/dropblock.cu``) replace the TPU kernel
``axcnn/pallas/dropblock.py:dropblock_mask_pallas`` and the apply that
``dropblock_pallas`` left to XLA. The mask kernel takes per-sample int32
seeds and a drop rate ``gamma`` and returns the (N, H, W) fp32 keep-mask and
the (N,) fp32 per-sample keep counts. A pixel's uniform comes from the top
24 bits of a stateless hash of (seed, pixel index), MurmurHash3's fmix32
applied twice; block centres are drawn in the valid region and expanded by a
separable ``bs``-tap max, as in the reference. The apply kernel rescales a
channels_last activation by the mask and ``numel / (max(sum(counts), 1) * C)``,
forward ``(x * m) * s`` and backward ``(g * s) * m``, in fp32, cast once. The
fused kernel does both forward in one cooperative launch: it draws the mask
and counts as the mask kernel does, waits at a grid-wide barrier, then
applies them as the apply kernel does, for the maps ``fused_route`` takes.

``dropblock_mask_reference`` computes the same hash with torch integer ops,
so kernel and plain version agree bit for bit. Given ``uniforms`` it uses
those instead: the hook through which the CPU tests hand in the reference's
own random draws. ``dropblock_apply_reference`` and
``dropblock_apply_bwd_reference`` are the apply's plain versions (the second
is autograd through the first); ``dropblock_fused_reference``, the two plain
versions in turn, is the fused kernel's. ``LAUNCHES`` counts the mask
kernel's launches, ``APPLY_LAUNCHES`` and ``APPLY_BWD_LAUNCHES`` the apply
kernel's by direction, ``FUSED_LAUNCHES`` the fused kernel's, and
``APPLY_NOT_CHANNELS_LAST`` the apply and fused calls whose tensor was not
channels_last-contiguous and so was copied first.

Spatial partitioning (a rank holds rows ``[row0, row0 + H)`` of every map of
``h_global`` rows): the mask kernel and its plain version take ``row0`` and
``h_global`` and draw the window's rows of the global mask, bit for bit
(the hash's pixel index and the centre region are global), with the
window's per-sample counts; the apply kernel and its plain versions take the
counts of the global batch (any length) and its element count ``numel``,
apart from the tensor's own N and numel. A spatial site whose global map
``fused_route`` takes takes the fused kernel with a window instead
(``dropblock_fused_window_cuda``; the main path's site is its trivial
window): given the global batch's seeds and this rank's first sample, one
cooperative launch draws every global sample over its whole global map,
writes the global batch's counts and the window of this rank's samples, and
applies them forward, so no sum over ranks sits between the mask and the
apply. ``dropblock_fused_window_reference`` is its plain version (the plain
mask of the whole global batch, its window's rows, the plain apply);
``FUSED_WINDOW_LAUNCHES`` counts the launches of this wrapper.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from axcnn_torch.kernels.build import entry, launch

LAUNCHES = 0
APPLY_LAUNCHES = 0
APPLY_BWD_LAUNCHES = 0
APPLY_NOT_CHANNELS_LAST = 0
FUSED_LAUNCHES = 0
FUSED_WINDOW_LAUNCHES = 0
# the fused kernel holds a sample's two byte maps, 2 * H * W bytes, in shared
# memory: the maps of the whole-map mask kernel (kWholeMapHW in dropblock.cu)
FUSED_MAX_HW = 16384
MAX_INT32 = 2 ** 31 - 1  # the kernels index pixels (mask), samples and channels (apply) with ints

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry points' parameters, in order
# (seeds, gamma, mask, counts, n, h, w, bs, row0, h_global, stream)
MASK_ARGTYPES = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                 *[ctypes.c_longlong] * 6, ctypes.c_void_p]
# (src, mask, counts, dst, dtype, numel, n, hw, c, n_counts, backward, stream)
APPLY_ARGTYPES = [*[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_float,
                  *[ctypes.c_longlong] * 4, ctypes.c_int, ctypes.c_void_p]
# (src, seeds, gamma, dst, mask, counts, dtype, numel, n, h, w, c, bs, row0, h_global, first,
#  n_global, stream)
FUSED_ARGTYPES = [*[ctypes.c_void_p] * 2, ctypes.c_float, *[ctypes.c_void_p] * 3, ctypes.c_int,
                  ctypes.c_float, *[ctypes.c_longlong] * 9, ctypes.c_void_p]

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32): the product is split
    into 16-bit halves of ``a`` so no partial product leaves int64."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_uniforms(seeds: torch.Tensor, h: int, w: int, row0: int = 0) -> torch.Tensor:
    """(N,) int32 seeds -> (N, H, W) fp32 uniforms in [0, 1) of rows
    ``row0 .. row0 + h - 1``, exactly as the kernel draws them:
    ``fmix32(fmix32(seed) ^ pixel) >> 8`` times 2**-24."""
    key = _fmix32(seeds.to(torch.int64) & _M32)
    pix = torch.arange(row0 * w, (row0 + h) * w, dtype=torch.int64, device=seeds.device)
    bits = _fmix32(key[:, None] ^ pix[None, :])
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).view(-1, h, w)


def check_mask_args(h: int, w: int, block_size: int, row0: int = 0,
                    h_global: int | None = None) -> None:
    """``h``: the window's rows, ``row0 .. row0 + h - 1`` of ``h_global``
    (``h`` when None)."""
    hg = h if h_global is None else h_global
    if hg * w > MAX_INT32:
        raise ValueError(f"the DropBlock mask takes H*W <= {MAX_INT32} (the pixel index "
                         f"is an int and a 32-bit hash input), got {hg}x{w}")
    if not 1 <= block_size <= min(hg, w):
        raise ValueError(f"block_size must be in [1, min(H, W)], got "
                         f"{block_size} for {hg}x{w}")
    if row0 < 0 or row0 + h > hg:
        raise ValueError(f"rows {row0}..{row0 + h - 1} are not rows of a map of {hg}")


def dropblock_mask_reference(seeds: torch.Tensor, gamma, h: int, w: int,
                             block_size: int, uniforms: torch.Tensor | None = None, *,
                             row0: int = 0, h_global: int | None = None):
    """Plain PyTorch keep-mask: ``(mask (N, H, W) fp32, counts (N,) fp32)``.
    ``gamma`` is a float (fp32 on the host); ``uniforms``, when given,
    replace the hashed draws: (N, H, W), the whole map's. With ``row0`` and
    ``h_global`` the mask is rows ``row0 .. row0 + h - 1`` of the map of
    ``h_global`` rows, its counts those of the window (``uniforms`` are
    then still the whole map's, (N, h_global, W))."""
    hg = h if h_global is None else h_global
    check_mask_args(h, w, block_size, row0, hg)
    bs = block_size
    half0, half1 = (bs - 1) // 2, bs // 2
    # the centres of the rows the window's row-max reads, global rows
    # row0 - half0 .. row0 + h - 1 + half1, clipped to the map; zeros past it
    lo, hi = max(row0 - half0, 0), min(row0 + h + half1, hg)
    if uniforms is None:
        u = hash_uniforms(seeds, hi - lo, w, lo)
    else:
        u = uniforms.float()[:, lo:hi]
    row = torch.arange(lo, hi, device=u.device)[:, None]
    col = torch.arange(w, device=u.device)[None, :]
    valid = (row >= half0) & (row < hg - half1) & (col >= half0) & (col < w - half1)
    centres = ((u < torch.tensor(gamma, dtype=torch.float32)) & valid).float()
    # separable max over offsets -half1..half0, each a window centred as
    # reduce_window's with padding (half0, half1)
    centres = F.pad(centres[:, None], (0, 0, lo - (row0 - half0), row0 + h + half1 - hi))
    hit = F.max_pool2d(centres, (bs, 1), 1)
    hit = F.max_pool2d(F.pad(hit, (half0, half1, 0, 0)), (1, bs), 1)[:, 0]
    mask = 1.0 - hit
    return mask, mask.sum(dim=(1, 2))


def dropblock_scale_reference(counts: torch.Tensor, numel: int, c: int) -> torch.Tensor:
    """The rescale ``numel / (max(sum(counts), 1) * c)`` as a 0-d tensor, in
    fp32 as the reference takes it (``numel`` rounded to fp32 first). The
    integer counts are summed exactly (in float64) and the sum rounded to
    fp32 once: below 2**24 that is the reference's fp32 sum, bit for bit."""
    total_keep = torch.clamp_min(counts.double().sum().float(), 1.0) * c
    numel = torch.full((), float(numel), dtype=torch.float32, device=counts.device)
    return numel / total_keep


def dropblock_apply_reference(x: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor,
                              numel: int | None = None) -> torch.Tensor:
    """Plain PyTorch apply on NCHW: ``(x * mask * scale)`` in fp32, cast back
    once. ``counts`` and ``numel`` (``x.numel()`` when None) are those the
    scale takes: the global batch's under spatial partitioning."""
    scale = dropblock_scale_reference(counts, x.numel() if numel is None else numel, x.shape[1])
    return (x.float() * mask[:, None] * scale).to(x.dtype)


def dropblock_apply_bwd_reference(g: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor,
                                  numel: int | None = None) -> torch.Tensor:
    """Plain PyTorch apply backward: autograd's order through
    ``dropblock_apply_reference``, ``(g * scale) * mask`` in fp32, cast back
    once."""
    scale = dropblock_scale_reference(counts, g.numel() if numel is None else numel, g.shape[1])
    return (g.float() * scale * mask[:, None]).to(g.dtype)


def dropblock_fused_reference(x: torch.Tensor, seeds: torch.Tensor, gamma, block_size: int,
                              uniforms: torch.Tensor | None = None):
    """The fused kernel's plain version: the plain mask, then the plain
    apply; ``(y, mask, counts)``."""
    _, _, h, w = x.shape
    mask, counts = dropblock_mask_reference(seeds, gamma, h, w, block_size, uniforms)
    return dropblock_apply_reference(x, mask, counts), mask, counts


def dropblock_fused_window_reference(x: torch.Tensor, seeds: torch.Tensor, gamma,
                                     block_size: int, *, row0: int, h_global: int, first: int,
                                     numel: int, uniforms: torch.Tensor | None = None):
    """The fused window kernel's plain version, for a rank that holds rows
    ``row0 .. row0 + H - 1`` of samples ``first .. first + N - 1`` of the
    global batch: ``seeds`` (N_g,) are the global batch's, ``uniforms``,
    when given, its whole maps, (N_g, h_global, W). The plain mask of every
    global sample over its whole map, the window's rows of this rank's
    samples, then the plain apply with the global counts and ``numel``;
    ``(y, mask (N, H, W), counts (N_g,))``."""
    n, _, h, w = x.shape
    if not 0 <= first <= first + n <= seeds.shape[0]:
        raise ValueError(f"samples {first}..{first + n - 1} are not samples of a global "
                         f"batch of {seeds.shape[0]}")
    check_mask_args(h, w, block_size, row0, h_global)
    whole, counts = dropblock_mask_reference(seeds, gamma, h_global, w, block_size, uniforms)
    mask = whole[first:first + n, row0:row0 + h].contiguous()
    return dropblock_apply_reference(x, mask, counts, numel), mask, counts


def fused_route(h: int, w: int) -> bool:
    """Whether a site of H x W pixels takes the fused kernel on the card:
    ``H * W <= FUSED_MAX_HW`` (16,384 pixels), so a sample's two byte maps
    fit shared memory. The presets' 14x14 and 7x7 maps are far inside. A
    larger map takes two launches: the mask kernel (its tiled form), then
    the apply kernel. The route follows from the shape alone, before any
    launch; it is never a fallback on failure."""
    return h * w <= FUSED_MAX_HW


def dropblock_mask_cuda(seeds: torch.Tensor, gamma, h: int, w: int,
                        block_size: int, *, row0: int = 0, h_global: int | None = None):
    """Launch the mask kernel; raise on anything it does not take. It
    launches for any ``gamma``, 0 included (then nothing is dropped). With
    ``row0`` and ``h_global``: the window of ``dropblock_mask_reference``."""
    global LAUNCHES
    if seeds.device.type != "cuda":
        raise ValueError(f"dropblock_mask_cuda needs CUDA seeds, got {seeds.device}")
    if seeds.dtype != torch.int32 or seeds.dim() != 1:
        raise TypeError(f"seeds must be (N,) int32, got {seeds.dtype} "
                        f"{tuple(seeds.shape)}")
    hg = h if h_global is None else h_global
    check_mask_args(h, w, block_size, row0, hg)
    seeds = seeds.contiguous()
    n = seeds.shape[0]
    mask = torch.empty((n, h, w), dtype=torch.float32, device=seeds.device)
    counts = torch.empty((n,), dtype=torch.float32, device=seeds.device)
    if n == 0:
        return mask, counts
    stream = torch.cuda.current_stream(seeds.device).cuda_stream
    fn = entry("axcnn_dropblock_mask", MASK_ARGTYPES)
    err = launch("dropblock_mask", (seeds,), (mask, counts), fn,
                 seeds.data_ptr(), float(gamma), mask.data_ptr(), counts.data_ptr(), n, h, w,
                 block_size, row0, hg, stream)
    if err != 0:
        raise RuntimeError(f"axcnn_dropblock_mask failed: CUDA error {err}")
    LAUNCHES += 1
    return mask, counts


def _check_activation(x: torch.Tensor, fn: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{fn} takes NCHW, got shape {tuple(x.shape)}")


def _check_int_sizes(x: torch.Tensor, kernel: str) -> None:
    n, c = x.shape[:2]
    if max(n, c) > MAX_INT32:
        raise ValueError(f"the DropBlock {kernel} kernel takes N and C <= {MAX_INT32} (ints in "
                         f"the kernel), got N={n}, C={c}")


def _check_apply_args(x: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor,
                      global_counts: bool) -> None:
    """Raise on what the apply kernel does not take: type, shape and size
    first, then the device. ``global_counts``: the counts may be the global
    batch's, of any length from 1 on."""
    _check_activation(x, "dropblock_apply_cuda")
    n, _, h, w = x.shape
    if mask.dtype != torch.float32 or tuple(mask.shape) != (n, h, w):
        raise ValueError(f"mask must be ({n}, {h}, {w}) float32, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if global_counts:
        if counts.dtype != torch.float32 or counts.dim() != 1 or not 1 <= counts.shape[0] \
                <= MAX_INT32:
            raise ValueError(f"counts must be (K,) float32 with 1 <= K <= {MAX_INT32}, got "
                             f"{counts.dtype} {tuple(counts.shape)}")
    elif counts.dtype != torch.float32 or tuple(counts.shape) != (n,):
        raise ValueError(f"counts must be ({n},) float32, got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    _check_int_sizes(x, "apply")
    for t in (x, mask, counts):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"dropblock_apply_cuda needs CUDA tensors on one device, got "
                             f"{x.device}, {mask.device}, {counts.device}")


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` in channels_last, copied (and counted) where it is not."""
    global APPLY_NOT_CHANNELS_LAST
    if x.is_contiguous(memory_format=torch.channels_last):
        return x
    APPLY_NOT_CHANNELS_LAST += 1
    return x.contiguous(memory_format=torch.channels_last)


def dropblock_apply_cuda(x: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor, *,
                         backward: bool = False, numel: int | None = None) -> torch.Tensor:
    """Launch the apply kernel: forward ``(x * m) * s``, or with ``backward``
    the cotangent ``(x * s) * m``; raise on anything it does not take. A
    tensor that is not channels_last-contiguous is counted and copied into
    that layout first. The result is channels_last. Launches on the current
    stream of the calling thread, which for autograd is its backward
    thread. ``numel`` (the global batch's element count; ``x.numel()`` when
    None) comes with the global batch's ``counts``, of any length."""
    global APPLY_LAUNCHES, APPLY_BWD_LAUNCHES
    _check_apply_args(x, mask, counts, numel is not None)
    x = _channels_last(x)
    mask, counts = mask.contiguous(), counts.contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    n, c, h, w = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = entry("axcnn_dropblock_apply", APPLY_ARGTYPES)
    err = launch("dropblock_apply_bwd" if backward else "dropblock_apply", (x, mask, counts),
                 (y,), fn, x.data_ptr(), mask.data_ptr(), counts.data_ptr(), y.data_ptr(),
                 _DTYPE_CODES[x.dtype], float(x.numel() if numel is None else numel), n, h * w,
                 c, counts.shape[0], int(backward), stream)
    if err != 0:
        raise RuntimeError(f"axcnn_dropblock_apply failed: CUDA error {err}")
    if backward:
        APPLY_BWD_LAUNCHES += 1
    else:
        APPLY_LAUNCHES += 1
    return y


def _launch_fused(name: str, x: torch.Tensor, seeds: torch.Tensor, gamma, block_size: int, *,
                  row0: int, h_global: int, first: int, numel: int):
    """The fused kernel's launch, under ``name``, for a checked ``x`` and
    ``seeds`` on the card: ``(y, mask, counts, launched)``; nothing is
    launched for N = 0."""
    n, c, h, w = x.shape
    x, seeds = _channels_last(x), seeds.contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mask = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
    counts = torch.empty((seeds.shape[0],), dtype=torch.float32, device=x.device)
    if n == 0:
        return y, mask, counts, False
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = entry("axcnn_dropblock_fused", FUSED_ARGTYPES)
    err = launch(name, (x, seeds), (y, mask, counts), fn, x.data_ptr(), seeds.data_ptr(),
                 float(gamma), y.data_ptr(), mask.data_ptr(), counts.data_ptr(),
                 _DTYPE_CODES[x.dtype], float(numel), n, h, w, c, block_size, row0, h_global,
                 first, seeds.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"axcnn_dropblock_fused failed: CUDA error {err}")
    return y, mask, counts, True


def dropblock_fused_cuda(x: torch.Tensor, seeds: torch.Tensor, gamma, block_size: int):
    """Launch the fused kernel: draw the keep-mask of ``seeds`` at rate
    ``gamma`` and apply it forward, ``(x * m) * s``, in one cooperative
    launch. Returns ``(y, mask, counts)``, bit for bit what the mask kernel
    and then the apply kernel give; ``y`` is channels_last. Takes the maps
    of ``fused_route`` (H * W <= FUSED_MAX_HW) and raises on a larger one:
    the caller chooses the route from the shape. A tensor that is not
    channels_last-contiguous is counted in ``APPLY_NOT_CHANNELS_LAST`` and
    copied first, as the apply does. Raises on anything the kernel does not
    take (type, shape and size first, then the device) and on a launch the
    runtime refuses; nothing else is tried."""
    global FUSED_LAUNCHES
    _check_activation(x, "dropblock_fused_cuda")
    n, c, h, w = x.shape
    if seeds.dtype != torch.int32 or tuple(seeds.shape) != (n,):
        raise TypeError(f"seeds must be ({n},) int32, got {seeds.dtype} {tuple(seeds.shape)}")
    check_mask_args(h, w, block_size)
    if not fused_route(h, w):
        raise ValueError(f"the fused DropBlock kernel takes H*W <= {FUSED_MAX_HW}, got {h}x{w}: "
                         "a larger map takes the mask kernel, then the apply kernel")
    _check_int_sizes(x, "fused")
    if x.device.type != "cuda" or seeds.device != x.device:
        raise ValueError(f"dropblock_fused_cuda needs CUDA tensors on one device, got "
                         f"{x.device}, {seeds.device}")
    # the whole batch: the kernel's trivial window
    y, mask, counts, launched = _launch_fused("dropblock_fused", x, seeds, gamma, block_size,
                                              row0=0, h_global=h, first=0, numel=x.numel())
    FUSED_LAUNCHES += launched
    return y, mask, counts


def dropblock_fused_window_cuda(x: torch.Tensor, seeds: torch.Tensor, gamma, block_size: int,
                                *, row0: int, h_global: int, first: int, numel: int):
    """Launch the fused kernel for a spatial site: ``x`` holds rows
    ``row0 .. row0 + H - 1`` of samples ``first .. first + N - 1`` of a
    global batch whose seeds are ``seeds`` (N_g,) and whose element count is
    ``numel``. One cooperative launch draws every global sample's mask over
    its whole map of ``h_global`` rows and applies this rank's window
    forward. Returns ``(y, mask (N, H, W), counts (N_g,))``, bit for bit
    what the windowed mask kernel, the window counts' sum over the ranks and
    the apply kernel give; ``y`` is channels_last. Takes global maps that
    ``fused_route`` takes and raises on a larger one. Raises on anything the
    kernel does not take (type, shape and size first, then the device) and
    on a launch the runtime refuses; nothing else is tried."""
    global FUSED_WINDOW_LAUNCHES
    _check_activation(x, "dropblock_fused_window_cuda")
    n, c, h, w = x.shape
    if seeds.dtype != torch.int32 or seeds.dim() != 1:
        raise TypeError(f"seeds must be (N_g,) int32, got {seeds.dtype} {tuple(seeds.shape)}")
    n_global = seeds.shape[0]
    if not 0 <= first <= first + n <= n_global:
        raise ValueError(f"samples {first}..{first + n - 1} are not samples of a global "
                         f"batch of {n_global}")
    check_mask_args(h, w, block_size, row0, h_global)
    if not fused_route(h_global, w):
        raise ValueError(f"the fused DropBlock kernel takes H*W <= {FUSED_MAX_HW}, got "
                         f"{h_global}x{w}: a larger map takes the windowed mask kernel, the "
                         "counts' sum over the ranks, then the apply kernel")
    _check_int_sizes(x, "fused")
    if n_global > MAX_INT32:
        raise ValueError(f"the DropBlock fused kernel takes N_g <= {MAX_INT32} (an int in the "
                         f"kernel), got {n_global}")
    if x.device.type != "cuda" or seeds.device != x.device:
        raise ValueError(f"dropblock_fused_window_cuda needs CUDA tensors on one device, got "
                         f"{x.device}, {seeds.device}")
    y, mask, counts, launched = _launch_fused("dropblock_fused_window", x, seeds, gamma,
                                              block_size, row0=row0, h_global=h_global,
                                              first=first, numel=numel)
    FUSED_WINDOW_LAUNCHES += launched
    return y, mask, counts


class DropBlockApply(torch.autograd.Function):
    """The apply kernel with itself, in backward order, as its gradient (the
    apply of ``dropblock_pallas``, which XLA differentiated). Only the mask
    and the counts are saved; the scale is formed again in the backward.
    ``numel``: with the global batch's counts, its element count."""

    @staticmethod
    def forward(ctx, x, mask, counts, numel=None):
        ctx.save_for_backward(mask, counts)
        ctx.numel = numel
        return dropblock_apply_cuda(x, mask, counts, numel=numel)

    @staticmethod
    def backward(ctx, g):
        mask, counts = ctx.saved_tensors
        return dropblock_apply_cuda(g, mask, counts, backward=True, numel=ctx.numel), None, \
            None, None


class DropBlockFused(torch.autograd.Function):
    """The fused kernel forward (mask and apply in one launch), the apply
    kernel in backward order as its gradient. Only the mask and the counts
    are saved; the scale is formed again in the backward."""

    @staticmethod
    def forward(ctx, x, seeds, gamma, block_size):
        y, mask, counts = dropblock_fused_cuda(x, seeds, gamma, block_size)
        ctx.save_for_backward(mask, counts)
        return y

    @staticmethod
    def backward(ctx, g):
        mask, counts = ctx.saved_tensors
        return dropblock_apply_cuda(g, mask, counts, backward=True), None, None, None


class DropBlockFusedWindow(torch.autograd.Function):
    """The fused window kernel forward (the global batch's counts, this
    rank's window of the mask and its apply, in one launch), the apply
    kernel in backward order with the global counts as its gradient."""

    @staticmethod
    def forward(ctx, x, seeds, gamma, block_size, row0, h_global, first, numel):
        y, mask, counts = dropblock_fused_window_cuda(x, seeds, gamma, block_size, row0=row0,
                                                      h_global=h_global, first=first,
                                                      numel=numel)
        ctx.save_for_backward(mask, counts)
        ctx.numel = numel
        return y

    @staticmethod
    def backward(ctx, g):
        mask, counts = ctx.saved_tensors
        return (dropblock_apply_cuda(g, mask, counts, backward=True, numel=ctx.numel),
                *[None] * 7)
