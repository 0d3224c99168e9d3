"""The spatial DropBlock site as one fused launch, on the CPU.

Under spatial partitioning every rank holds the global batch's seeds, so a
site within the fused line counts every global sample over its whole map
itself (the fused window kernel) instead of summing its window counts over
the ranks. Here, in one process:

- ``dropblock_fused_window_reference`` (the kernel's plain version) gives,
  bit for bit, what the route it replaces gives: the windowed mask of the
  rank's samples, the window counts summed over the spatial row and the data
  shards' concatenated in data order, then the apply with those counts, for
  every rank of ``(D, S)`` in {1, 2} x {2, 4} and a grid of 3 rows (windows
  that cut a block), block sizes 7 and 5, hashed and injected draws;
- at the rank's rows it equals the reference's ``axcnn.ops.dropblock.dropblock``
  on the whole global batch with the same uniforms (tolerance 0, as
  tests/test_torch_spatial.py holds the windows to the global mask), and so
  does its gradient;
- the op's route: a CPU tensor takes the plain version with no collective
  and no launch; a tensor off the CPU takes ``DropBlockFusedWindow`` within
  the line and the windowed mask, ``SpatialContext.global_counts`` and the
  apply past it;
- the new wrapper refuses what the kernel does not take before it loads the
  library.

The kernel itself is checked on the card in tests/test_torch_kernels.py; the
Gloo step's collectives in tests/test_torch_spatial.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axcnn.ops.dropblock import dropblock as j_dropblock
from axcnn_torch.kernels import dropblock as kdrop
from axcnn_torch.ops import dropblock as op_dropblock
from axcnn_torch.ops.dropblock import dropblock, dropblock_gamma
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

# (H_global, W, bs, S): S shards of H_global rows; 3 rows of 9 cut a block
GRIDS = [(14, 14, 7, 2), (28, 28, 7, 4), (28, 17, 5, 2), (9, 11, 5, 3), (28, 28, 5, 4)]
N = 3  # samples a data shard
COUNTERS = ("LAUNCHES", "APPLY_LAUNCHES", "APPLY_BWD_LAUNCHES", "FUSED_LAUNCHES",
            "FUSED_WINDOW_LAUNCHES")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _today(x, seeds, gamma, bs, uniforms, d, s, parts, data, hg):
    """The route the fused window kernel replaces, for rank (d, s): the
    window of its samples, every window's counts summed over the row and
    the data shards' concatenated, then the apply."""
    n, _, h, w = x.shape

    def window(dd, ss):
        own = seeds[dd * n:(dd + 1) * n]
        u = None if uniforms is None else uniforms[dd * n:(dd + 1) * n]
        return kdrop.dropblock_mask_reference(own, gamma, h, w, bs, u, row0=ss * h, h_global=hg)

    counts = torch.cat([sum(window(dd, ss)[1] for ss in range(parts)) for dd in range(data)])
    mask = window(d, s)[0]
    numel = x.numel() * parts * data
    return kdrop.dropblock_apply_reference(x, mask, counts, numel), mask, counts


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("hg,w,bs,parts", GRIDS)
@pytest.mark.parametrize("injected", [False, True])
def test_fused_window_reference_is_todays_route(hg, w, bs, parts, data, injected):
    g = torch.Generator().manual_seed(hg * w + bs + parts + data)
    n_global, h, c = N * data, hg // parts, 6
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_global,), dtype=torch.int32, generator=g)
    uniforms = (torch.rand(n_global, hg, w, generator=g, dtype=torch.float64) if injected
                else None)
    gamma = 0.1
    dropped = False
    for d in range(data):
        for s in range(parts):
            x = torch.randn(N, c, h, w, generator=g).contiguous(memory_format=torch.channels_last)
            x[0, 0, 0, 0], x[-1, -1, -1, -1] = float("nan"), float("inf")
            want = _today(x, seeds, gamma, bs, uniforms, d, s, parts, data, hg)
            got = kdrop.dropblock_fused_window_reference(
                x, seeds, gamma, bs, row0=s * h, h_global=hg, first=d * N,
                numel=x.numel() * parts * data, uniforms=uniforms)
            assert torch.equal(_bits(got[0]), _bits(want[0]))
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            assert got[1].shape == (N, h, w) and got[2].shape == (n_global,)
            dropped = dropped or bool((got[1] == 0).any())
    assert dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hg,w,bs,parts", GRIDS[:3])
def test_fused_window_reference_matches_the_reference_on_the_global_map(hg, w, bs, parts,
                                                                        dtype):
    """Every rank of D2xS``parts``: its rows of the reference's DropBlock
    of the whole global batch, and of its ``jax.vjp``, with the reference's
    uniforms handed in. Tolerance 0."""
    data, kp, c = 2, 0.5, 8
    shape = (N * data, hg, w, c)
    key = jax.random.key(hg + w + bs)
    u = torch.from_numpy(np.array(jax.random.uniform(key, shape[:3] + (1,), jnp.float32))[..., 0])
    rng = np.random.default_rng(hg * w)
    x, gy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want_y, vjp = jax.vjp(lambda a: j_dropblock(key, a, keep_prob=kp, block_size=bs, train=True),
                          jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(gy, jdt))
    want_y, want_dx = np.asarray(want_y, np.float32), np.asarray(want_dx, np.float32)
    gamma = float(dropblock_gamma(kp, bs, hg, w))
    h = hg // parts
    seeds = torch.zeros(N * data, dtype=torch.int32)
    for d in range(data):
        for s in range(parts):
            rows = (slice(d * N, (d + 1) * N), slice(s * h, (s + 1) * h))
            xt = torch.from_numpy(x[rows]).permute(0, 3, 1, 2).to(tdt).requires_grad_()
            y, mask, counts = kdrop.dropblock_fused_window_reference(
                xt, seeds, gamma, bs, row0=s * h, h_global=hg, first=d * N, numel=x.size,
                uniforms=u)
            (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy[rows]).permute(
                0, 3, 1, 2).to(tdt))
            np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).float().numpy(),
                                          want_y[rows])
            np.testing.assert_array_equal(dx.permute(0, 2, 3, 1).float().numpy(), want_dx[rows])


class _Grid:
    """A stand-in ``SpatialContext`` for rank (d, s) that records
    ``global_counts`` calls and returns ``counts`` as the global ones."""

    def __init__(self, d, s, data, parts, calls, counts=None):
        self.data_index, self.index, self.data_parts, self.parts = d, s, data, parts
        self.calls, self.counts = calls, counts

    def rows(self, h):
        return self.index * h, self.parts * h

    def global_counts(self, counts):
        self.calls.append(("global_counts",
                           tuple(counts.shape) if torch.is_tensor(counts) else ()))
        return self.counts


def test_op_on_cpu_takes_the_plain_version_with_no_collective():
    """Rank (1, 1) of D2xS2 on a CPU tensor: the plain fused window
    version, through autograd; no ``global_counts`` call, no launch."""
    data, parts, hg, w, c, kp = 2, 2, 14, 14, 8, 0.8
    rng = np.random.default_rng(47)
    x = torch.from_numpy(rng.standard_normal((N, c, hg // parts, w)).astype(np.float32))
    x.requires_grad_()
    seeds = rng.integers(-2 ** 31, 2 ** 31, N * data, dtype=np.int32)
    calls = []
    before = [getattr(kdrop, k) for k in COUNTERS]
    y = dropblock(x, seeds, keep_prob=kp, block_size=7, train=True,
                  spatial=_Grid(1, 1, data, parts, calls))
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert calls == [] and [getattr(kdrop, k) for k in COUNTERS] == before
    want, mask, counts = kdrop.dropblock_fused_window_reference(
        x, torch.from_numpy(seeds), float(dropblock_gamma(kp, 7, hg, w)), 7, row0=hg // parts,
        h_global=hg, first=N, numel=x.numel() * data * parts)
    assert torch.equal(y, want)
    assert torch.equal(dx, kdrop.dropblock_apply_bwd_reference(
        torch.ones_like(y), mask, counts, x.numel() * data * parts))
    with pytest.raises(ValueError, match="global batch's 6"):
        dropblock(x, seeds[:N], keep_prob=kp, block_size=7, train=True,
                  spatial=_Grid(1, 1, data, parts, calls))


def test_op_past_the_line_on_cpu_sums_the_window_counts():
    """A map past the line (the line moved to 0 here) on the CPU: the
    windowed mask of the rank's samples, ``global_counts``, the apply: the
    same result as the fused window version."""
    data, parts, hg, w, c, kp = 2, 2, 14, 14, 4, 0.8
    rng = np.random.default_rng(48)
    x = torch.from_numpy(rng.standard_normal((N, c, hg // parts, w)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, N * data, dtype=np.int32))
    gamma = float(dropblock_gamma(kp, 7, hg, w))
    want, _, counts = kdrop.dropblock_fused_window_reference(
        x, seeds, gamma, 7, row0=0, h_global=hg, first=N, numel=x.numel() * data * parts)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kdrop, "FUSED_MAX_HW", 0)
        y = dropblock(x, seeds, keep_prob=kp, block_size=7, train=True,
                      spatial=_Grid(1, 0, data, parts, calls, counts))
    assert calls == [("global_counts", (N,))]
    assert torch.equal(y, want)


class _Recorder:
    """Stands in for a kernel wrapper or an autograd Function: records each
    call's arguments (a tensor as its device, dtype and length) and returns
    the input, or ``result``."""

    def __init__(self, name, calls, result=None):
        self.name, self.calls, self.result = name, calls, result

    def _record(self, args):
        self.calls.append((self.name, tuple((a.device.type, a.dtype, a.shape[0])
                                            if torch.is_tensor(a) else a for a in args)))

    def apply(self, *args):
        self._record(args)
        return args[0]

    def __call__(self, *args, **kw):
        self._record(args + tuple(kw.values()))
        return self.result


@pytest.mark.parametrize("hw,fused", [((28, 28), True), ((14, 14), True), ((256, 160), False)])
def test_op_routes_card_tensors_by_global_map_size(hw, fused, monkeypatch):
    """A tensor off the CPU (a meta tensor stands in: the route is chosen
    before anything launches) on rank (1, 1) of D2xS2: the fused window
    Function with the global seeds, the window, the first sample and the
    global element count within the line; past it the windowed mask of
    the rank's seeds, ``global_counts`` and the apply Function."""
    hg, w = hw
    data, parts, h, c = 2, 2, hw[0] // 2, 8
    calls = []
    monkeypatch.setattr(op_dropblock, "DropBlockFusedWindow", _Recorder("window", calls))
    monkeypatch.setattr(op_dropblock, "DropBlockApply", _Recorder("apply", calls))
    monkeypatch.setattr(op_dropblock, "dropblock_mask_cuda",
                        _Recorder("mask", calls, result=("mask", "counts")))
    x = torch.empty(N, c, h, w, device="meta")
    y = dropblock(x, np.arange(N * data, dtype=np.int32), keep_prob=0.9, block_size=7,
                  train=True, spatial=_Grid(1, 1, data, parts, calls, "global"))
    gamma = float(dropblock_gamma(0.9, 7, hg, w))
    numel = x.numel() * data * parts
    xt = ("meta", torch.float32, N)
    assert y is x
    if fused:
        assert calls == [("window", (xt, ("meta", torch.int32, N * data), gamma, 7, h, hg, N,
                                     numel))]
    else:
        assert calls == [("mask", (("meta", torch.int32, N), gamma, h, w, 7, h, hg)),
                         ("global_counts", ()), ("apply", (xt, "mask", "global", numel))]


def _window_args(n=2, c=8, h=6, w=6, dtype=torch.float32, seeds_dtype=torch.int32,
                 n_global=4, first=2, row0=6, h_global=12, bs=3):
    return ((torch.zeros(n, c, h, w, dtype=dtype), torch.zeros(n_global, dtype=seeds_dtype),
             0.1, bs), dict(row0=row0, h_global=h_global, first=first, numel=1))


WINDOW_REFUSALS = {  # case -> (the wrapper's arguments, the exception, its message)
    "cpu_tensor": (_window_args, ValueError, "CUDA tensors"),
    "float64": (lambda: _window_args(dtype=torch.float64), TypeError, "float32 or bfloat16"),
    "not_4d": (lambda: ((torch.zeros(2, 8, 36),) + _window_args()[0][1:], _window_args()[1]),
               ValueError, "NCHW"),
    "seeds_int64": (lambda: _window_args(seeds_dtype=torch.int64), TypeError, "seeds must be"),
    "first_past_the_batch": (lambda: _window_args(first=3), ValueError, "global batch of 4"),
    "rows_past_the_map": (lambda: _window_args(row0=7), ValueError, "not rows of a map"),
    "block_size": (lambda: _window_args(bs=7), ValueError, "block_size"),
    "past_the_line": (lambda: _window_args(h=100, w=100, row0=100, h_global=200), ValueError,
                      "H\\*W <= 16384"),
}


@pytest.mark.parametrize("case", list(WINDOW_REFUSALS))
def test_fused_window_wrapper_refuses_before_loading_the_library(case, monkeypatch):
    from axcnn_torch.kernels import build

    def no_load():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load_library", no_load)
    make_args, exc, match = WINDOW_REFUSALS[case]
    args, kw = make_args()
    before = (kdrop.FUSED_WINDOW_LAUNCHES, kdrop.APPLY_NOT_CHANNELS_LAST)
    with pytest.raises(exc, match=match):
        kdrop.dropblock_fused_window_cuda(*args, **kw)
    assert (kdrop.FUSED_WINDOW_LAUNCHES, kdrop.APPLY_NOT_CHANNELS_LAST) == before


def test_fused_window_function_refuses_cpu_tensors():
    (x, seeds, gamma, bs), kw = _window_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kdrop.DropBlockFusedWindow.apply(x.requires_grad_(), seeds, gamma, bs, *kw.values())


def test_the_fused_window_entry_point_takes_the_same_line():
    """The fused entry point refuses a global map past kWholeMapHW, as
    ``fused_route`` routes it away, and a window or a sample range outside
    the global batch's maps, as the wrapper does."""
    import pathlib

    src = (pathlib.Path(kdrop.__file__).parents[1] / "csrc" / "dropblock.cu").read_text()
    entry = src[src.index('extern "C" int axcnn_dropblock_fused'):]
    checks = entry[:entry.index("return")]
    for bound in ("h_global * w > kWholeMapHW", "row0 + h > h_global", "first + n > n_global"):
        assert bound in checks
