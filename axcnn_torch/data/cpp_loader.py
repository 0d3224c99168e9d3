"""ctypes bindings for the native loader (cpp/loader.cpp) + a drop-in
batch decoder used by TFRecordImageLoader when ``loader='cpp'``.

Split of responsibilities (SURVEY.md §2.9): Python owns file IO, shuffle
order, determinism and checkpoint state (cheap, already golden-tested);
C++ owns Example parse + JPEG decode + crop/resize/flip (the CPU-hot path),
multithreaded and GIL-free (ctypes releases the GIL for the call).

The port's own copy of ``axcnn/data/cpp_loader.py``, so that the port runs
without the JAX package installed, with its own build. The reference's
``cpp/build.sh`` links the system's libjpeg, whose headers or library a
host may lack (a CUDA host with Pillow's wheel has neither). The port
compiles the same sources, ``cpp/loader.cpp`` and ``cpp/autoaugment.cpp``,
with the same flags, against the libjpeg that Pillow decodes with (the one
its ``_imaging`` module loaded: the wheel's own copy, ABI 62) and the
libjpeg-turbo headers of that ABI kept in ``axcnn_torch/data/libjpeg/``,
into ``axcnn_torch/build/libaxcnn_loader.so`` at first use. A failed build
raises ``RuntimeError`` with the compiler's stderr, and the first load
decodes a probe JPEG and holds it to Pillow's pixels (the same library, so
bit for bit); nothing falls back to another decoder. Set
``AXCNN_NO_CPP=1`` to refuse the native path, or ``AXCNN_LOADER_SO`` to
load another build (a sanitizer build of ``cpp/build.sh``).
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
import tempfile

import numpy as np

_LIB = None
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP_DIR = os.path.join(os.path.dirname(_PKG), "cpp")
_INCLUDE = os.path.join(_PKG, "data", "libjpeg")
_SO_PATH = os.path.join(_PKG, "build", "libaxcnn_loader.so")
_CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-Wall")


def pillow_libjpeg() -> str:
    """The path of the libjpeg that Pillow's ``_imaging`` module loaded."""
    from PIL import _imaging  # noqa: F401 - loads Pillow's libjpeg

    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libjpeg") and os.path.isfile(path):
                return path
    raise RuntimeError("Pillow's libjpeg is not loaded in this process: the native "
                       "loader links the libjpeg Pillow decodes with")


def _build():
    """Compile the native loader into ``_SO_PATH`` (through a temporary name,
    so that concurrent builds never load a partial library)."""
    libjpeg = pillow_libjpeg()
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_SO_PATH), suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *_CXXFLAGS, f"-I{_INCLUDE}", os.path.join(_CPP_DIR, "loader.cpp"),
             os.path.join(_CPP_DIR, "autoaugment.cpp"), "-o", tmp, libjpeg,
             f"-Wl,-rpath,{os.path.dirname(libjpeg)}", "-lpthread"],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"the native loader's build failed (g++ exit "
                               f"{proc.returncode}): {proc.stderr.strip()[:4000]}")
        os.replace(tmp, _SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


_ABI_VERSION = 3

# AutoAugment policy ids (must match AaOp policy selection in
# cpp/autoaugment.cpp); -1 disables augmentation
AA_POLICIES = {"none": -1, "": -1, "v0": 0, "imagenet": 1}

# op ids matching cpp/autoaugment.h AaOp (and the order of the Python
# NAME_TO_OP table) — used by the per-op parity tests
AA_OPS = {name: i for i, name in enumerate([
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Color", "Contrast", "Brightness", "Sharpness",
    "Posterize", "Solarize", "SolarizeAdd", "AutoContrast", "Equalize",
    "Invert", "Cutout"])}


def get_lib():
    """Load (building if needed) the native library; raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if os.environ.get("AXCNN_NO_CPP"):
        raise RuntimeError("native loader disabled via AXCNN_NO_CPP")
    so_path = os.environ.get("AXCNN_LOADER_SO", _SO_PATH)  # sanitizer builds
    if so_path == _SO_PATH and not os.path.exists(so_path):
        _build()

    def _load(path, *, private_copy):
        # dlopen a PRIVATE COPY of the default build output: a later rebuild
        # rewrites the same inode the handle has mmapped (undefined behavior
        # for any non-resident page), and glibc's path-based dedup would
        # hand the stale cached handle back on re-CDLL. A fresh temp file
        # sidesteps both.
        tmp = None
        if private_copy:
            import shutil

            fd, tmp = tempfile.mkstemp(prefix="axcnn_loader_", suffix=".so")
            os.close(fd)
            shutil.copy2(path, tmp)
            path = tmp
        handle = ctypes.CDLL(path)
        if tmp is not None:
            # POSIX keeps the mapping valid after unlink; deleting now means
            # no axcnn_loader_*.so accumulates in the temp dir across
            # processes / test workers
            os.unlink(tmp)
        handle.axcnn_version.restype = ctypes.c_int
        return handle

    try:
        lib = _load(so_path, private_copy=so_path == _SO_PATH)
    except OSError:
        if so_path != _SO_PATH:
            raise
        # a build from another host (its libjpeg elsewhere): build afresh
        _build()
        lib = _load(so_path, private_copy=True)
    if lib.axcnn_version() != _ABI_VERSION:
        if so_path != _SO_PATH:
            raise RuntimeError(
                f"{so_path} has loader ABI {lib.axcnn_version()}, expected "
                f"{_ABI_VERSION} — rebuild it")
        # stale default build from an older checkout: rebuild (safe — the
        # live mapping is the private copy, not the build output)
        _build()
        lib = _load(so_path, private_copy=True)
        if lib.axcnn_version() != _ABI_VERSION:
            raise RuntimeError("rebuilt loader still reports wrong ABI "
                               f"({lib.axcnn_version()} != {_ABI_VERSION})")
    lib.axcnn_decode_batch.restype = ctypes.c_int
    lib.axcnn_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # payloads
        ctypes.POINTER(ctypes.c_int64),    # sizes
        ctypes.c_int,                      # n
        ctypes.c_int,                      # image_size
        ctypes.c_int,                      # resize_min
        ctypes.c_int,                      # train
        ctypes.c_int,                      # dct_fast (JDCT_IFAST decode)
        ctypes.c_int,                      # aa_policy (-1 none, 0 v0, 1 imagenet)
        ctypes.POINTER(ctypes.c_uint64),   # seeds
        ctypes.POINTER(ctypes.c_uint8),    # out_images
        ctypes.POINTER(ctypes.c_int32),    # out_labels
        ctypes.c_int,                      # num_threads
    ]
    lib.axcnn_decode_jpeg.restype = ctypes.c_int
    lib.axcnn_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.axcnn_aa_op.restype = ctypes.c_int
    lib.axcnn_aa_op.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _LIB = lib
    try:
        _check_decode()
    except BaseException:
        _LIB = None
        raise
    return lib


def _check_decode() -> None:
    """Decode a probe JPEG natively and hold it to Pillow's decode."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=90)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    try:
        same = np.array_equal(decode_jpeg_native(buf.getvalue(), max_side=64), want)
    except ValueError:  # the decoder refused the probe
        same = False
    if not same:
        raise RuntimeError("the native loader does not decode a probe JPEG as Pillow does: "
                           f"is its libjpeg of another ABI than {_INCLUDE}'s headers?")


def available() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


def decode_batch(payloads, *, image_size: int, resize_min: int,
                 train: bool, seeds, num_threads: int = 8,
                 dct_fast: bool = False, aa_policy: int = -1):
    """Decode serialized Examples → (images uint8 [n,S,S,3], labels int32 [n],
    n_ok). Failed records get zeros/label=-1. ``aa_policy``: AutoAugment
    policy id applied on the train path (see AA_POLICIES).

    Payloads may be ``bytes`` or read-only ``np.uint8`` views (the
    MmapShardReader hot path) — either way the C++ side reads them IN PLACE:
    no per-record copy is made here (the round-2 version memcpy'd every
    payload through ``create_string_buffer``, a measured serial-section term
    of the single producer thread)."""
    lib = get_lib()
    n = len(payloads)
    images = np.empty((n, image_size, image_size, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    if n and isinstance(payloads[0], np.ndarray):
        # zero-copy views into the shard mmap
        ptrs = (ctypes.c_void_p * n)(*[p.ctypes.data for p in payloads])
        sizes = (ctypes.c_int64 * n)(*[p.size for p in payloads])
    else:
        # c_char_p array borrows each bytes object's buffer (no copy);
        # `arr` keeps the references alive through the call
        arr = (ctypes.c_char_p * n)(*payloads)
        ptrs = ctypes.cast(arr, ctypes.POINTER(ctypes.c_void_p))
        sizes = (ctypes.c_int64 * n)(*[len(p) for p in payloads])
    if isinstance(seeds, np.ndarray) and seeds.dtype == np.uint64:
        seed_np = np.ascontiguousarray(seeds)
        seed_arr = seed_np.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    else:
        seed_arr = (ctypes.c_uint64 * n)(*[int(s) & (2**64 - 1) for s in seeds])
    ok = lib.axcnn_decode_batch(
        ptrs, sizes, n, image_size, resize_min, int(train), int(dct_fast),
        int(aa_policy), seed_arr,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_threads)
    return images, labels, ok


def aa_op(img, op: str, mag: int, *, sign: int = 1, cutout_xy=(0, 0)):
    """Apply one native AutoAugment op to an HWC uint8 array (returns a new
    array). Test/tool API: the stochastic draws (sign, cutout center) are
    pinned by the caller so each op can be compared against the PIL
    reference bit-for-bit."""
    lib = get_lib()
    out = np.ascontiguousarray(img, np.uint8).copy()
    h, w, c = out.shape
    assert c == 3
    rc = lib.axcnn_aa_op(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        AA_OPS[op], mag, sign, cutout_xy[0], cutout_xy[1])
    if rc != 0:
        raise ValueError(f"aa_op failed (rc={rc})")
    return out


def decode_jpeg_native(data: bytes, *, max_side: int = 8192):
    """Single-image native JPEG decode (tests/tools)."""
    lib = get_lib()
    out = np.empty((max_side * max_side * 3,), np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.axcnn_decode_jpeg(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return out[: w.value * h.value * 3].reshape(h.value, w.value, 3).copy()
