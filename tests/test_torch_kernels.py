"""The port's hand-written kernels, held against their plain PyTorch versions.

This file imports no JAX, so on a machine with a CUDA card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``cuda`` launch the kernels and skip where there is no CUDA
device (a CUDA kernel has no CPU mode); the rest check the plain versions and
the wrappers' routing and refusals on the CPU. Parity of the plain versions
with the JAX reference is in tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch

from axcnn_torch.kernels import blurpool as kblur
from axcnn_torch.kernels import dropblock as kdrop
from axcnn_torch.ops.blurpool import blur_pool
from axcnn_torch.ops.dropblock import dropblock
import torch_inprocess

capped_threads = torch_inprocess.capped_threads


def _nchw(shape_nhwc, seed, device="cpu", dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape_nhwc).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype).permute(0, 3, 1, 2)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def test_blur_reference_bf16_rounds_once():
    x = _nchw((2, 9, 8, 16), 12, dtype=torch.bfloat16)
    got = kblur.blur_pool_reference(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kblur.blur_pool_reference(x.float()).to(torch.bfloat16))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (1, 1), (2, 3)])
def test_blur_reference_against_direct_sum(hw):
    """The even/odd form against the definition: out[i,j] = sum of
    w[a] w[b] x[2i-1+a, 2j-1+b] over the zero-padded image, w = [1,2,1]/4."""
    x = _nchw((2, *hw, 3), 15).double()
    h, w = hw
    xp = torch.nn.functional.pad(x, (1, 2, 1, 2))
    k = torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64) / 4
    want = torch.zeros(2, 3, (h + 1) // 2, (w + 1) // 2, dtype=torch.float64)
    for a in range(3):
        for b in range(3):
            want += k[a] * k[b] * xp[:, :, a:a + 2 * want.shape[2]:2,
                                     b:b + 2 * want.shape[3]:2]
    got = kblur.blur_pool_reference(x.float())
    torch.testing.assert_close(got.double(), want, atol=1e-6, rtol=1e-6)


def test_blur_pool_routes_cpu_tensors_to_reference():
    x = _nchw((1, 6, 6, 8), 13)
    before = kblur.LAUNCHES
    assert torch.equal(blur_pool(x), kblur.blur_pool_reference(x))
    assert kblur.LAUNCHES == before  # the kernel was not launched


def test_blur_pool_refuses_what_it_does_not_take():
    """The kernel entry takes 3x3/2 only, refused before the device; the op
    routes every other size to its general version instead."""
    x = torch.zeros(1, 8, 6, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kblur.blur_pool_cuda(x)
    with pytest.raises(NotImplementedError, match="filter_size=3, stride=2"):
        kblur.blur_pool_cuda(x, filter_size=5)
    with pytest.raises(NotImplementedError):
        kblur.blur_pool_cuda(x, stride=3)
    assert blur_pool(x, filter_size=5).shape == (1, 8, 3, 3)
    assert blur_pool(x, stride=3).shape == (1, 8, 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 56, 56, 128), (3, 15, 17, 96), (2, 7, 9, 3)])
def test_kernel_matches_reference_on_card(shape, dtype):
    _cuda()
    x = _nchw(shape, 14, "cuda", dtype)
    before = kblur.LAUNCHES
    got = kblur.blur_pool_cuda(x)
    torch.cuda.synchronize()
    assert kblur.LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    # the same fp32 terms in the same order, rounded once: bit-identical
    assert torch.equal(got, kblur.blur_pool_reference(x))


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs_on_card():
    _cuda()
    x = _nchw((2, 8, 8, 16), 16, "cuda")
    with pytest.raises(ValueError, match="channels_last"):
        kblur.blur_pool_cuda(x.contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kblur.blur_pool_cuda(x.half())
    with pytest.raises(NotImplementedError):
        kblur.blur_pool_cuda(x, filter_size=5)


# ---------------------------------------------------------------------------
# BlurPool backward and its autograd Function
# ---------------------------------------------------------------------------

def _grad_for(shape_nhwc, seed, device="cpu", dtype=torch.float32):
    n, h, w, c = shape_nhwc
    return _nchw((n, (h + 1) // 2, (w + 1) // 2, c), seed, device, dtype)


def test_blur_bwd_reference_against_the_forward_transpose():
    """<D x, g> == <x, D^T g>: the plain backward is the transpose of the
    plain forward, odd extents included (both compute in fp32; the inner
    products are taken in float64, so rtol 1e-6 covers fp32 rounding)."""
    for hw in [(8, 8), (7, 9), (1, 1), (2, 3), (15, 17)]:
        x, g = _nchw((2, *hw, 3), 17), _grad_for((2, *hw, 3), 18)
        lhs = (kblur.blur_pool_reference(x).double() * g.double()).sum()
        rhs = (x.double() * kblur.blur_pool_bwd_reference(g, hw).double()).sum()
        torch.testing.assert_close(lhs, rhs, rtol=1e-6, atol=1e-6)


def test_blur_bwd_refuses_what_it_does_not_take():
    g = torch.zeros(1, 8, 3, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kblur.blur_pool_bwd_cuda(g, (6, 6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 56, 56, 128), (4, 28, 28, 256), (4, 14, 14, 512),
                                   (3, 15, 17, 96), (2, 8, 9, 3)])
def test_bwd_kernel_matches_reference_on_card(shape, dtype):
    _cuda()
    g = _grad_for(shape, 19, "cuda", dtype)
    before = kblur.BWD_LAUNCHES
    got = kblur.blur_pool_bwd_cuda(g, shape[1:3])
    torch.cuda.synchronize()
    assert kblur.BWD_LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, kblur.blur_pool_bwd_reference(g, shape[1:3]))
    # autograd may hand in a gradient in another memory format
    assert torch.equal(kblur.blur_pool_bwd_cuda(g.contiguous(), shape[1:3]), got)


# ---------------------------------------------------------------------------
# The two routes: TMA tiles, and one thread per element for what a tensor
# map cannot describe
# ---------------------------------------------------------------------------

# TMA tile edges (a short last row band and odd extents on one sample;
# column bands; a channel block half outside C), C at the smallest TMA-legal
# widths (8; 4 in fp32 only), and C only the per-thread route takes (6; 4 in
# bf16); the forward's input extents
EDGE_SHAPES = [(1, 57, 58, 128), (2, 9, 199, 64), (3, 15, 17, 96), (3, 15, 17, 8),
               (2, 13, 11, 4), (2, 7, 9, 6)]


def _padded_channels_last(shape_nhwc, seed, device, dtype, pad_w):
    """A channels_last NCHW view whose rows are ``pad_w`` pixels longer in
    memory than W: C innermost, but not channels_last-contiguous."""
    n, h, w, c = shape_nhwc
    base = _nchw((n, h, w + pad_w, c), seed, device, dtype)
    return base[..., :w]


def _route_launched(kind, before):
    new = {k: v - before[k] for k, v in kblur.ROUTES.items() if k.startswith(kind)}
    assert sum(new.values()) == 1, new
    return next(k for k, v in new.items() if v)[len(kind) + 1:]


def _tma_legal(c, dtype):
    return c * torch.tensor([], dtype=dtype).element_size() % 16 == 0


ENTRIES = {  # C entry point -> (its source, the argtypes its wrapper sets)
    "axcnn_blur_pool3_s2": ("blurpool.cu", kblur.ENTRY_ARGTYPES),
    "axcnn_blur_pool3_s2_bwd": ("blurpool.cu", kblur.ENTRY_ARGTYPES),
    "axcnn_dropblock_mask": ("dropblock.cu", kdrop.MASK_ARGTYPES),
    "axcnn_dropblock_apply": ("dropblock.cu", kdrop.APPLY_ARGTYPES),
    "axcnn_dropblock_fused": ("dropblock.cu", kdrop.FUSED_ARGTYPES),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_argtypes_match_the_c_signature(name):
    """The ctypes binding passes the C entry point's parameters one for one,
    each of its C type (a mismatch would not fail at the call; ctypes cannot
    see C)."""
    import ctypes
    import pathlib
    import re

    c_types = {"void*": ctypes.c_void_p, "int*": ctypes.POINTER(ctypes.c_int),
               "int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
    source, argtypes = ENTRIES[name]
    src = (pathlib.Path(kblur.__file__).parents[1] / "csrc" / source).read_text()
    params = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src).group(1).split(",")
    # "const void* seeds" -> "void*"; "long long n" -> "long long"
    types = [re.fullmatch(r"\s*(?:const\s+)?(.*?)\s*\w+\s*", p).group(1) for p in params]
    assert [c_types[t] for t in types] == list(argtypes)


def test_entry_binds_each_c_function_once(monkeypatch):
    """``build.entry`` loads the library and sets a function's argtypes and
    int return once; later calls return the same bound function."""
    import ctypes
    import types

    from axcnn_torch.kernels import build

    loads = []

    def fake_load():
        loads.append(1)
        return types.SimpleNamespace(axcnn_fake=lambda *a: 0)

    monkeypatch.setattr(build, "load_library", fake_load)
    monkeypatch.setattr(build, "_entries", {})
    fn = build.entry("axcnn_fake", [ctypes.c_int])
    assert build.entry("axcnn_fake", [ctypes.c_int]) is fn and len(loads) == 1
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_route_edges_match_reference_on_card(kind, shape, dtype):
    _cuda()
    before = dict(kblur.ROUTES)
    if kind == "fwd":
        x = _nchw(shape, 24, "cuda", dtype)
        got, want = kblur.blur_pool_cuda(x), kblur.blur_pool_reference(x)
    else:
        g = _grad_for(shape, 24, "cuda", dtype)
        got = kblur.blur_pool_bwd_cuda(g, shape[1:3])
        want = kblur.blur_pool_bwd_reference(g, shape[1:3])
    torch.cuda.synchronize()
    assert _route_launched(kind, before) == ("tma" if _tma_legal(shape[3], dtype) else "thread")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_misaligned_input_takes_the_per_thread_route_on_card(kind, dtype):
    """A channels_last tensor one element into its storage is not 16-byte
    aligned: a tensor map cannot describe it, the per-thread kernel takes it."""
    _cuda()
    n, h, w, c = 2, 15, 17, 64
    in_shape = (n, h, w, c) if kind == "fwd" else (n, (h + 1) // 2, (w + 1) // 2, c)
    flat = torch.from_numpy(np.random.default_rng(25).standard_normal(
        1 + int(np.prod(in_shape))).astype(np.float32)).to("cuda", dtype)
    x = flat[1:].view(in_shape).permute(0, 3, 1, 2)
    assert x.data_ptr() % 16 and x.is_contiguous(memory_format=torch.channels_last)
    before = dict(kblur.ROUTES)
    if kind == "fwd":
        got, want = kblur.blur_pool_cuda(x), kblur.blur_pool_reference(x)
    else:
        got = kblur.blur_pool_bwd_cuda(x, (h, w))
        want = kblur.blur_pool_bwd_reference(x, (h, w))
    torch.cuda.synchronize()
    assert _route_launched(kind, before) == "thread"
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_copies_a_padded_gradient_on_card(dtype):
    """A gradient whose C is innermost but whose rows are padded is counted
    as not channels_last, copied, and then takes the TMA route."""
    _cuda()
    shape = (3, 15, 17, 64)
    g = _padded_channels_last((3, 8, 9, 64), 26, "cuda", dtype, 3)
    assert not g.is_contiguous(memory_format=torch.channels_last)
    before, counted = dict(kblur.ROUTES), kblur.BWD_G_NOT_CHANNELS_LAST
    got = kblur.blur_pool_bwd_cuda(g, shape[1:3])
    torch.cuda.synchronize()
    assert kblur.BWD_G_NOT_CHANNELS_LAST == counted + 1
    assert _route_launched("bwd", before) == "tma"
    assert torch.equal(got, kblur.blur_pool_bwd_reference(g, shape[1:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradient_matches_autograd_of_plain_forward_on_card(dtype):
    _cuda()
    shape = (3, 15, 17, 96)
    x = _nchw(shape, 20, "cuda", dtype).requires_grad_()
    g = _grad_for(shape, 21, "cuda", dtype)
    fwd, bwd = kblur.LAUNCHES, kblur.BWD_LAUNCHES
    blur_pool(x).backward(g)
    assert (kblur.LAUNCHES, kblur.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    x2 = x.detach().clone().requires_grad_()
    kblur.blur_pool_reference(x2).backward(g)
    assert torch.equal(x.grad, x2.grad)


# ---------------------------------------------------------------------------
# DropBlock mask
# ---------------------------------------------------------------------------

def test_dropblock_routes_cpu_tensors_to_reference():
    x = _nchw((2, 14, 14, 8), 22)
    seeds = np.array([3, 4], np.int32)
    before = kdrop.LAUNCHES
    y = dropblock(x, seeds, keep_prob=0.8, block_size=7, train=True)
    assert kdrop.LAUNCHES == before
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_dropblock_mask_kernel_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA seeds"):
        kdrop.dropblock_mask_cuda(torch.zeros(2, dtype=torch.int32), 0.1, 14, 14, 7)
    # any map the pixel index can address: 200x200 (past the old 16,384-pixel
    # shared-memory bound) is taken; 46341^2 > 2^31 - 1 is not
    kdrop.check_mask_args(200, 200, 7)
    with pytest.raises(ValueError, match="H\\*W <= 2147483647"):
        kdrop.check_mask_args(46341, 46341, 7)
    with pytest.raises(ValueError, match="block_size"):
        kdrop.check_mask_args(5, 5, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,bs", [(14, 14, 7), (7, 7, 7), (15, 17, 5), (160, 160, 7),
                                    (3, 50000, 3)])
@pytest.mark.parametrize("gamma", [0.0, 0.02, 0.1])
def test_mask_kernel_matches_reference_on_card(h, w, bs, gamma):
    _cuda()
    seeds = torch.from_numpy(np.random.default_rng(23).integers(
        -2 ** 31, 2 ** 31, 128, dtype=np.int32)).cuda()
    before = kdrop.LAUNCHES
    mask, counts = kdrop.dropblock_mask_cuda(seeds, gamma, h, w, bs)
    torch.cuda.synchronize()
    assert kdrop.LAUNCHES == before + 1  # it launches for gamma = 0 too
    want_m, want_c = kdrop.dropblock_mask_reference(seeds, gamma, h, w, bs)
    assert torch.equal(mask, want_m) and torch.equal(counts, want_c)
    if gamma == 0.0:
        assert bool((mask == 1).all())


@pytest.mark.cuda
def test_dropblock_op_on_card_matches_cpu():
    """The op on the card (the fused kernel) equals the op on the CPU (plain
    versions) bit for bit, from the same seeds."""
    _cuda()
    x = _nchw((8, 14, 14, 64), 24)
    seeds = np.random.default_rng(25).integers(-2 ** 31, 2 ** 31, 8, dtype=np.int32)
    want = dropblock(x, seeds, keep_prob=0.8, block_size=7, train=True)
    got = dropblock(x.cuda(), seeds, keep_prob=0.8, block_size=7, train=True)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropblock_op_gradient_on_card_matches_cpu(dtype):
    """Output and input gradient of the op on the card (the fused kernel
    forward, the apply kernel backward) equal the op's on the CPU (plain
    versions under autograd) bit for bit, from the same seeds."""
    _cuda()
    shape = (8, 14, 14, 64)
    x, g = _nchw(shape, 26, dtype=dtype), _nchw(shape, 27, dtype=dtype)
    seeds = np.random.default_rng(28).integers(-2 ** 31, 2 ** 31, 8, dtype=np.int32)
    out = {}
    for device in ("cpu", "cuda"):
        xd = x.to(device).requires_grad_()
        y = dropblock(xd, seeds, keep_prob=0.8, block_size=7, train=True)
        (dx,) = torch.autograd.grad(y, xd, g.to(device))
        out[device] = (y.detach().cpu(), dx.cpu())
    assert bool((out["cpu"][0] == 0).any())  # something was dropped
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_dropblock_op_runs_only_its_kernels_on_card():
    """Under ``torch.profiler`` the op's forward puts on the card only the
    seeds' copy and the fused kernel, and its backward only the apply
    kernel."""
    _cuda()
    from torch.profiler import ProfilerActivity, profile

    from axcnn_torch.cli.profile_step import device_events

    shape = (8, 14, 14, 64)
    x = _nchw(shape, 29, "cuda", torch.bfloat16).requires_grad_()
    g = _nchw(shape, 30, "cuda", torch.bfloat16)
    seeds = np.random.default_rng(31).integers(-2 ** 31, 2 ** 31, 8, dtype=np.int32)

    def fwd():
        return dropblock(x, seeds, keep_prob=0.8, block_size=7, train=True)

    torch.autograd.grad(fwd(), x, g)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_fwd:
        y = fwd()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_bwd:
        torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()

    def kinds(prof):
        names = [e.name for e in device_events(prof)]
        keys = ("Memcpy HtoD", "dropblock_fused_kernel", "dropblock_apply_kernel")
        assert all(any(k in n for k in keys) for n in names), names
        return sorted(next(k for k in keys if k in n) for n in names)

    assert kinds(prof_fwd) == ["Memcpy HtoD", "dropblock_fused_kernel"]
    assert kinds(prof_bwd) == ["dropblock_apply_kernel"]


def test_profile_breakdown_counts_union_and_categories():
    """``profile_step``'s per-step totals: busy time is the union of the
    device events' intervals, each event falls in the first matching
    category."""
    import types

    from torch.autograd import DeviceType

    from axcnn_torch.cli.profile_step import breakdown, category, device_events

    def ev(name, start, end):
        return types.SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev("void (anonymous namespace)::dropblock_apply_kernel<float>", 0.0, 40.0),
              ev("void at::native::elementwise_kernel<128, 2, at::native::Mul>", 30.0, 50.0),
              ev("Memcpy HtoD (Pageable -> Device)", 100.0, 110.0),
              ev("void blur3_s2_tma_kernel<__nv_bfloat16>", 200.0, 220.0)]
    assert category("void at::native::vectorized_elementwise_kernel<4, copy>") == (
        "other elementwise, copies and casts")
    # an NCCL all-reduce is a collective, not a reduction; the span that
    # ProcessGroupNCCL's annotation draws over it is not a second event
    nccl = ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 60, 70)
    assert category(nccl.name) == "NCCL collectives"
    prof = types.SimpleNamespace(events=lambda: [nccl, ev("nccl:all_reduce", 60, 70)])
    assert device_events(prof) == [nccl]
    out = breakdown([(e.name, e.time_range.start, e.time_range.end) for e in events],
                    steps=2, wall_s=0.001)
    assert out["busy_ms"] == (50.0 + 10.0 + 20.0) / 1e3 / 2
    assert out["device_events"] == 2.0 and out["wall_ms"] == 0.5
    assert out["by_category_ms"] == {"hand-written kernels": 0.03,
                                     "elementwise_kernel<128, 2>": 0.01,
                                     "memcpy and memset": 0.005}


# ---------------------------------------------------------------------------
# DropBlock apply
# ---------------------------------------------------------------------------

def _bits(t):
    """The bit patterns of ``t``: equal bits hold NaNs and signed zeros too."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _apply_inputs(shape_nhwc, seed, device, dtype, offset=0):
    """A channels_last input with inf, -inf and NaN at a dropped and at a
    kept pixel, its seeds, and their hashed mask (drop rate 0.1, block size
    up to 7) with its counts. ``offset`` elements into the storage (not
    16-byte aligned)."""
    n, h, w, c = shape_nhwc
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32))
    mask, counts = kdrop.dropblock_mask_reference(seeds, 0.1, h, w, min(7, h, w))
    for keep in (0.0, 1.0):
        hit = (mask[0] == keep).nonzero()
        if len(hit):
            r, col = hit[len(hit) // 2].tolist()
            x[0, r, col, :3] = [np.inf, -np.inf, np.nan][:c]
    flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), x.ravel()]))
    xt = flat.to(device, dtype)[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    return xt, seeds.to(device), mask.to(device), counts.to(device)


# the R50 sites at batch 8; C = 8 (16 bytes in bf16), 6 and 4 (8 bytes in
# bf16, 16 in fp32): the per-element route where C * itemsize is not a
# multiple of 16 bytes
APPLY_SHAPES = [(8, 14, 14, 1024), (8, 7, 7, 2048), (4, 15, 17, 8), (4, 15, 17, 6),
                (4, 15, 17, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_kernel_matches_plain_on_card(shape, dtype, backward):
    _cuda()
    x, _, mask, counts = _apply_inputs(shape, 40, "cuda", dtype)
    counter = "APPLY_BWD_LAUNCHES" if backward else "APPLY_LAUNCHES"
    before = getattr(kdrop, counter)
    got = kdrop.dropblock_apply_cuda(x, mask, counts, backward=backward)
    torch.cuda.synchronize()
    assert getattr(kdrop, counter) == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    plain = kdrop.dropblock_apply_bwd_reference if backward else kdrop.dropblock_apply_reference
    want = plain(x, mask, counts)
    assert bool(want.isnan().any()) and bool(want.isinf().any())
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
def test_apply_kernel_takes_a_misaligned_tensor_on_card(backward, dtype):
    """A channels_last tensor one element into its storage is not 16-byte
    aligned; the entry point takes it one element at a time."""
    _cuda()
    x, _, mask, counts = _apply_inputs((2, 14, 14, 64), 41, "cuda", dtype, offset=1)
    assert x.data_ptr() % 16 and x.is_contiguous(memory_format=torch.channels_last)
    got = kdrop.dropblock_apply_cuda(x, mask, counts, backward=backward)
    plain = kdrop.dropblock_apply_bwd_reference if backward else kdrop.dropblock_apply_reference
    assert torch.equal(_bits(got), _bits(plain(x, mask, counts)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_copies_a_gradient_that_is_not_channels_last_on_card(dtype):
    _cuda()
    x, _, mask, counts = _apply_inputs((4, 14, 14, 64), 42, "cuda", dtype)
    g = x.contiguous()  # NCHW-contiguous
    assert not g.is_contiguous(memory_format=torch.channels_last)
    counted, launched = kdrop.APPLY_NOT_CHANNELS_LAST, kdrop.APPLY_BWD_LAUNCHES
    got = kdrop.dropblock_apply_cuda(g, mask, counts, backward=True)
    assert (kdrop.APPLY_NOT_CHANNELS_LAST, kdrop.APPLY_BWD_LAUNCHES) == (counted + 1,
                                                                         launched + 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(got), _bits(kdrop.dropblock_apply_bwd_reference(g, mask, counts)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_function_gradient_matches_autograd_of_plain_on_card(dtype):
    _cuda()
    x, _, mask, counts = _apply_inputs((4, 14, 14, 64), 43, "cuda", dtype)
    g = _nchw((4, 14, 14, 64), 44, "cuda", dtype)
    x1, x2 = x.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
    (got,) = torch.autograd.grad(kdrop.DropBlockApply.apply(x1, mask, counts), x1, g)
    (want,) = torch.autograd.grad(kdrop.dropblock_apply_reference(x2, mask, counts), x2, g)
    assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# DropBlock fused: the mask and the forward apply in one cooperative launch
# ---------------------------------------------------------------------------

# the R50 sites at batch 128; N = 1; N past the cooperative grid (at 7x7x8
# one CTA's units cover many samples, so CTAs draw several masks); an odd C
# (the per-element route)
FUSED_SHAPES = [(128, 14, 14, 1024), (128, 7, 7, 2048), (1, 14, 14, 1024), (1500, 7, 7, 8),
                (4, 15, 17, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_kernel_matches_plain_on_card(shape, dtype):
    """Output bit for bit (NaNs included) against the plain mask then the
    plain apply; the mask and counts equal the mask kernel's."""
    _cuda()
    n, h, w, c = shape
    bs = min(7, h, w)
    x, seeds, _, _ = _apply_inputs(shape, 45, "cuda", dtype)
    before = (kdrop.FUSED_LAUNCHES, kdrop.LAUNCHES, kdrop.APPLY_LAUNCHES)
    y, mask, counts = kdrop.dropblock_fused_cuda(x, seeds, 0.1, bs)
    torch.cuda.synchronize()
    assert (kdrop.FUSED_LAUNCHES, kdrop.LAUNCHES, kdrop.APPLY_LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    assert y.is_contiguous(memory_format=torch.channels_last)
    want_y, want_m, want_c = kdrop.dropblock_fused_reference(x, seeds, 0.1, bs)
    assert bool(want_y.isnan().any()) and bool(want_y.isinf().any())
    assert torch.equal(_bits(y), _bits(want_y))
    got_m, got_c = kdrop.dropblock_mask_cuda(seeds, 0.1, h, w, bs)
    assert torch.equal(mask, got_m) and torch.equal(counts, got_c)
    assert torch.equal(mask, want_m) and torch.equal(counts, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_copies_a_tensor_that_is_not_channels_last_on_card(dtype):
    _cuda()
    x, seeds, _, _ = _apply_inputs((4, 14, 14, 64), 46, "cuda", dtype)
    x = x.contiguous()  # NCHW-contiguous
    counted, launched = kdrop.APPLY_NOT_CHANNELS_LAST, kdrop.FUSED_LAUNCHES
    y, _, _ = kdrop.dropblock_fused_cuda(x, seeds, 0.1, 7)
    assert (kdrop.APPLY_NOT_CHANNELS_LAST, kdrop.FUSED_LAUNCHES) == (counted + 1, launched + 1)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(y), _bits(kdrop.dropblock_fused_reference(x, seeds, 0.1, 7)[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_function_gradient_matches_autograd_of_plain_on_card(dtype):
    _cuda()
    x, seeds, _, _ = _apply_inputs((4, 14, 14, 64), 47, "cuda", dtype)
    g = _nchw((4, 14, 14, 64), 48, "cuda", dtype)
    x1, x2 = x.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
    y1 = kdrop.DropBlockFused.apply(x1, seeds, 0.1, 7)
    (got,) = torch.autograd.grad(y1, x1, g)
    y2 = kdrop.dropblock_fused_reference(x2, seeds, 0.1, 7)[0]
    (want,) = torch.autograd.grad(y2, x2, g)
    assert torch.equal(_bits(y1), _bits(y2)) and torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(14, 14), (128, 128), (128, 129)])
def test_op_routes_by_map_size_on_card(hw):
    """The op launches the fused kernel within the line and the mask kernel
    then the apply past it; the output is the CPU op's either way."""
    _cuda()
    h, w = hw
    x = _nchw((2, h, w, 8), 49)
    seeds = np.array([7, -8], np.int32)
    counters = ("FUSED_LAUNCHES", "LAUNCHES", "APPLY_LAUNCHES")
    before = [getattr(kdrop, k) for k in counters]
    got = dropblock(x.cuda(), seeds, keep_prob=0.8, block_size=7, train=True)
    launched = np.subtract([getattr(kdrop, k) for k in counters], before).tolist()
    assert launched == ([1, 0, 0] if kdrop.fused_route(h, w) else [0, 1, 1])
    want = dropblock(x, seeds, keep_prob=0.8, block_size=7, train=True)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gap_gradient_reaches_the_apply_without_a_copy_on_card(dtype):
    """DropBlock then the global average pool, as at the last stage-4 site:
    the pool's gradient is channels_last, so the apply backward copies
    nothing; the gradient equals autograd's through the plain mean on the
    card bit for bit (on the card PyTorch divides by a scalar as a multiply
    by its reciprocal, on the CPU it divides, so the devices differ in
    fp32)."""
    _cuda()
    from axcnn_torch.ops.pooling import global_avg_pool

    shape = (4, 7, 7, 64)
    seeds = np.random.default_rng(50).integers(-2 ** 31, 2 ** 31, 4, dtype=np.int32)
    g = torch.from_numpy(np.random.default_rng(51).standard_normal((4, 64)).astype(
        np.float32)).to("cuda", dtype)
    pools = {"port": global_avg_pool,
             "autograd": lambda t: t.float().mean(dim=(2, 3)).to(dtype)}
    out, copies = {}, {}
    for name, pool in pools.items():
        x = _nchw(shape, 52, "cuda", dtype).requires_grad_()
        y = dropblock(x, seeds, keep_prob=0.8, block_size=7, train=True)
        counted = kdrop.APPLY_NOT_CHANNELS_LAST
        (out[name],) = torch.autograd.grad(pool(y), x, g)
        copies[name] = kdrop.APPLY_NOT_CHANNELS_LAST - counted
    assert copies == {"port": 0, "autograd": 1}
    assert torch.equal(_bits(out["port"]), _bits(out["autograd"]))


# ---------------------------------------------------------------------------
# the kernels on the KD and gradient-accumulation paths
# ---------------------------------------------------------------------------

KD_CFG = dict(width_multiplier=0.125, num_classes=10, use_resnet_d=True,
              use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
              use_dropblock=True, dropblock_keep_prob=0.5, zero_gamma=True)


def _teacher(device):
    from axcnn_torch.models.resnet import ModelConfig, ResNet

    model = ResNet(ModelConfig(**KD_CFG), generator=torch.Generator().manual_seed(30))
    return model.to(device, memory_format=torch.channels_last).eval().requires_grad_(False)


def _kd_batch():
    rng = np.random.default_rng(31)
    return {"images": torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)),
            "labels": torch.from_numpy(rng.integers(0, 10, 8))}


def _counts():
    return (kblur.LAUNCHES, kblur.BWD_LAUNCHES, kdrop.LAUNCHES, kdrop.APPLY_LAUNCHES,
            kdrop.APPLY_BWD_LAUNCHES, kdrop.FUSED_LAUNCHES)


@pytest.mark.cuda
def test_teacher_forward_on_card():
    """The frozen teacher's no_grad forward launches the BlurPool forward
    kernel at the 3 stride-2 blocks and no backward; its logits agree with
    the CPU's plain path (fp32, TF32 off)."""
    _cuda()
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision

    set_fp32_precision(DEFAULT_POLICY)
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (4, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want = _teacher("cpu")(x)
        before = _counts()
        got = _teacher("cuda")(x.cuda()).cpu()
    assert np.subtract(_counts(), before).tolist() == [3, 0, 0, 0, 0, 0]
    assert (got - want).norm() / want.norm() <= 1e-4


@pytest.mark.cuda
def test_accumulated_kd_step_on_card():
    """One KD step with grad_accum_steps=2 on the card: per micro-batch the
    student's 3 forward and 3 backward BlurPool launches, the teacher's 3
    forward launches, 9 fused DropBlock launches and 9 apply backwards (no
    standalone mask or forward apply: the 4x4 and 2x2 maps are within the
    fused line); the loss agrees with the same step on the CPU through the
    plain versions."""
    _cuda()
    from axcnn_torch.core.dtypes import DEFAULT_POLICY, set_fp32_precision
    from axcnn_torch.models.resnet import ModelConfig
    from axcnn_torch.train.schedules import make_lr_schedule
    from axcnn_torch.train.train_step import create_train_state, make_train_step

    set_fp32_precision(DEFAULT_POLICY)
    cfg = ModelConfig(**KD_CFG)
    losses = {}
    for device in ("cpu", "cuda"):
        state = create_train_state(cfg, generator=torch.Generator().manual_seed(33),
                                   device=device)
        state.step = 5  # DropBlock drops
        step = make_train_step(cfg, lr_schedule=make_lr_schedule(
            base_lr=0.1, total_steps=10, warmup_steps=0), total_steps=10,
            mixup_alpha=0.2, teacher=_teacher(device), kd_temp=2.0, grad_accum_steps=2)
        before = _counts()
        state, metrics = step(state, {k: v.to(device) for k, v in _kd_batch().items()}, 7)
        losses[device] = metrics["loss"].item()
        if device == "cuda":
            torch.cuda.synchronize()
            assert np.subtract(_counts(), before).tolist() == [2 * (3 + 3), 2 * 3,
                                                               0, 0, 2 * 9, 2 * 9]
            assert all(torch.isfinite(v).all() for v in state.velocity.values())
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


# ---------------------------------------------------------------------------
# BlurPool as a custom op (the serving forward, and what a torch.export holds)
# ---------------------------------------------------------------------------

def test_blur_custom_op_cpu_is_the_plain_version():
    x = _nchw((2, 9, 8, 16), 21).contiguous(memory_format=torch.channels_last)
    got = torch.ops.axcnn.blur_pool3_s2(x)
    assert torch.equal(got, kblur.blur_pool_reference(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.library.opcheck(torch.ops.axcnn.blur_pool3_s2.default, (x,),
                          test_utils=("test_schema", "test_faketensor"))


def test_blur_pool_takes_the_custom_op_without_a_gradient():
    """No gradient asked for: the custom op; a gradient: the autograd route
    (on the CPU the plain version, which autograd differentiates)."""
    x = _nchw((1, 6, 6, 8), 22).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = blur_pool(x.requires_grad_())
    assert y.is_contiguous(memory_format=torch.channels_last) and not y.requires_grad
    z = blur_pool(x)
    assert z.requires_grad and torch.equal(z.detach(), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blur_custom_op_launches_the_kernel_on_card(dtype):
    _cuda()
    x = _nchw((4, 28, 28, 64), 23, "cuda", dtype).contiguous(memory_format=torch.channels_last)
    before = kblur.LAUNCHES
    with torch.inference_mode():
        got = torch.ops.axcnn.blur_pool3_s2(x)
    torch.cuda.synchronize()
    assert kblur.LAUNCHES == before + 1
    assert torch.equal(got, kblur.blur_pool_reference(x))


# ---------------------------------------------------------------------------
# the int8 conv's card route (torch._int_mm, cuBLASLt)
# ---------------------------------------------------------------------------

def test_int8_card_route_refuses_cpu_tensors():
    from axcnn_torch.ops.conv import int8_conv_acc_cuda

    xq = torch.zeros(1, 8, 4, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        int8_conv_acc_cuda(xq, torch.zeros(8, 8, 1, 1, dtype=torch.int8), stride=1,
                           dilation=1, padding=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (N, C, H, W, O, k, stride, dilation): 3x3, stride 2, dilation 2, the
    # stem's k = 27, 1x1 (no copy), rows under 17, N not a multiple of 8
    (2, 64, 14, 14, 64, 3, 1, 1), (2, 64, 14, 14, 64, 3, 2, 1), (2, 64, 14, 14, 64, 3, 1, 2),
    (2, 3, 32, 32, 32, 3, 2, 1), (2, 64, 7, 7, 256, 1, 1, 1), (1, 16, 2, 2, 16, 1, 1, 1),
    (2, 8, 9, 9, 12, 3, 1, 1)])
def test_int8_card_route_matches_plain_on_card(shape):
    _cuda()
    from axcnn_torch.ops import conv as kconv

    n, c, h, w, o, k, stride, dilation = shape
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(n, c, h, w, generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    wt = torch.randn(o, c, k, k, generator=gen, device="cuda")
    pad = kconv.fixed_pad_amounts(k, dilation)[0]
    xq, _, wq, _ = kconv.quantize_int8(x, wt)
    before = kconv.INT8_MM_CALLS
    got = kconv.int8_conv_acc_cuda(xq, wq, stride=stride, dilation=dilation, padding=pad)
    want = kconv.int8_conv_acc_reference(xq, wq, stride=stride, dilation=dilation, padding=pad)
    torch.cuda.synchronize()
    assert kconv.INT8_MM_CALLS == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# spatial partitioning: BlurPool with top padding 0, the windowed mask, the
# apply with the global batch's counts
# ---------------------------------------------------------------------------

def test_spatial_kernel_arguments_are_refused_on_the_cpu():
    """The wrappers refuse a top padding other than 0 or 1 and a window
    outside its map before they touch a device or the library."""
    x = _nchw((2, 9, 8, 8), 40)
    with pytest.raises(ValueError, match="pad_top must be 0 or 1"):
        kblur.blur_pool_cuda(x, pad_top=2)
    with pytest.raises(ValueError, match="pad_top must be 0 or 1"):
        kblur.blur_pool_bwd_cuda(x, (18, 16), pad_top=-1)
    with pytest.raises(ValueError, match="are not rows of a map of 14"):
        kdrop.dropblock_mask_reference(torch.zeros(2, dtype=torch.int32), 0.1, 7, 14, 7,
                                       row0=8, h_global=14)
    with pytest.raises(ValueError, match="block_size must be in"):
        kdrop.dropblock_mask_reference(torch.zeros(2, dtype=torch.int32), 0.1, 4, 14, 7,
                                       row0=0, h_global=6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 57, 112, 128), (2, 15, 28, 512), (3, 9, 17, 96),
                                   (3, 15, 17, 6), (1, 8, 9, 64)])
def test_pad_top_zero_kernels_match_plain_on_card(shape, dtype):
    """Top padding 0 (a shard with its halo row on top), both directions and
    both routes, bit for bit against the plain versions; where the rows are
    an even shard's and its halo row, the forward's rows are the unsharded
    kernel's."""
    _cuda()
    n, h, w, c = shape
    x = _nchw(shape, 41, "cuda", dtype).contiguous(memory_format=torch.channels_last)
    for kind in ("fwd", "bwd"):
        before = dict(kblur.ROUTES)
        if kind == "fwd":
            got, want = kblur.blur_pool_cuda(x, pad_top=0), kblur.blur_pool_reference(x, 0)
        else:
            g = _nchw((n, (h - 1) // 2, (w + 1) // 2, c), 42, "cuda", dtype)
            got = kblur.blur_pool_bwd_cuda(g, (h, w), pad_top=0)
            want = kblur.blur_pool_bwd_reference(g, (h, w), pad_top=0)
        torch.cuda.synchronize()
        assert _route_launched(kind, before) == ("tma" if _tma_legal(c, dtype) else "thread")
        assert torch.equal(got, want), kind
    if h % 2:  # a shard of h - 1 (even) rows and its halo row: the second of two
        full = _nchw((n, 2 * (h - 1), w, c), 43, "cuda", dtype)
        shard = full[:, :, h - 2:].contiguous(memory_format=torch.channels_last)
        assert torch.equal(kblur.blur_pool_cuda(shard, pad_top=0),
                           kblur.blur_pool_cuda(full)[:, :, (h - 1) // 2:])


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,bs,row0,rows", [(28, 28, 7, 14, 14), (14, 14, 7, 7, 7),
                                              (28, 28, 5, 9, 7), (160, 160, 7, 40, 80)])
def test_windowed_mask_kernel_matches_plain_on_card(h, w, bs, row0, rows):
    _cuda()
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (16,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(44)).cuda()
    window = dict(row0=row0, h_global=h)
    mask, counts = kdrop.dropblock_mask_cuda(seeds, 0.05, rows, w, bs, **window)
    whole, _ = kdrop.dropblock_mask_cuda(seeds, 0.05, h, w, bs)
    want_m, want_c = kdrop.dropblock_mask_reference(seeds, 0.05, rows, w, bs, **window)
    torch.cuda.synchronize()
    assert torch.equal(mask, want_m) and torch.equal(counts, want_c)
    assert torch.equal(mask, whole[:, row0:row0 + rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
def test_apply_with_global_counts_matches_plain_on_card(dtype, backward):
    _cuda()
    x = _nchw((4, 7, 14, 64), 45, "cuda", dtype).contiguous(memory_format=torch.channels_last)
    seeds = torch.arange(4, dtype=torch.int32, device="cuda")
    mask, counts = kdrop.dropblock_mask_cuda(seeds, 0.1, 7, 14, 5, row0=7, h_global=14)
    counts = torch.cat([counts, counts + 3.0, counts])  # three data shards' counts
    numel = 6 * x.numel()
    ref = kdrop.dropblock_apply_bwd_reference if backward else kdrop.dropblock_apply_reference
    got = kdrop.dropblock_apply_cuda(x, mask, counts, backward=backward, numel=numel)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(ref(x, mask, counts, numel)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hg,w,bs,parts,data,c", [(28, 28, 7, 2, 1, 1024), (14, 14, 7, 2, 2, 64),
                                                  (28, 28, 5, 4, 2, 64), (15, 17, 5, 3, 2, 6)])
def test_fused_window_kernel_matches_plain_on_card(dtype, hg, w, bs, parts, data, c):
    """Every rank of the grid: the fused window kernel's output (bit
    patterns, the input's inf and NaN included), mask and global counts
    against its plain version; the counts are the windowed mask kernel's
    window counts summed over the ranks; the autograd Function's gradient
    is the apply kernel's backward with the global counts."""
    _cuda()
    n, h = 4, hg // parts
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (n * data,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(46)).cuda()
    windows = [kdrop.dropblock_mask_cuda(seeds[d * n:(d + 1) * n], 0.1, h, w, bs, row0=s * h,
                                         h_global=hg)[1] for d in range(data) for s in range(parts)]
    summed = torch.cat([sum(windows[d * parts:(d + 1) * parts]) for d in range(data)])
    for d in range(data):
        for s in range(parts):
            x = _nchw((n, h, w, c), 47 + d * parts + s, "cuda", dtype).contiguous(
                memory_format=torch.channels_last)
            x[0, 0, 0, 0], x[-1, -1, -1, -1] = float("nan"), float("inf")
            window = dict(row0=s * h, h_global=hg, first=d * n, numel=x.numel() * parts * data)
            got = kdrop.dropblock_fused_window_cuda(x, seeds, 0.1, bs, **window)
            want = kdrop.dropblock_fused_window_reference(x, seeds, 0.1, bs, **window)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got[0]), _bits(want[0]))
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            assert torch.equal(got[2], summed)
            xg = x.clone().requires_grad_()
            y = kdrop.DropBlockFusedWindow.apply(xg, seeds, 0.1, bs, *window.values())
            g = _nchw((n, h, w, c), 48, "cuda", dtype).contiguous(memory_format=torch.channels_last)
            (dx,) = torch.autograd.grad(y, xg, g)
            assert torch.equal(_bits(y), _bits(got[0]))
            assert torch.equal(_bits(dx), _bits(kdrop.dropblock_apply_bwd_reference(
                g, got[1], got[2], window["numel"])))
