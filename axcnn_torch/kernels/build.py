"""Build and load the port's CUDA kernels.

Every ``axcnn_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per source, all started together, then one link. The build
happens at first use, into ``axcnn_torch/build/`` (git-ignored), and is
keyed on a hash of the sources and flags, so a fresh checkout builds itself
and an edited source rebuilds. Nothing here runs at import time.

``launch`` is the one call through which every wrapper enters its C entry
point. While a per-op accountant is active (``ACCOUNTANT``, set by
``axcnn_torch.cli.profile_roofline.RooflineAccountant``), it hands the call
to the accountant, which records the kernel's name and bytes and brackets
the launch in a profiler range of its own; otherwise it costs one ``None``
check. It adds no launch and changes no argument.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-ldl",)  # blurpool.cu finds its driver entry points with dlsym

_lib: ctypes.CDLL | None = None
_entries: dict = {}
# the active per-op accountant, if any (``launch``)
ACCOUNTANT = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of axcnn_torch "
            "are built from source at first use")
    return nvcc


def library_path() -> Path:
    """The library's path for the current sources (it may not exist yet)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libaxcnn_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a temporary directory and rename the library into place, so a
    # concurrent or interrupted build never leaves a partial library under
    # the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, so.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs, *LINK_FLAGS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, so)
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' shared library once."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def entry(name: str, argtypes):
    """The C entry point ``name`` (it returns a CUDA error code), bound once
    with ``argtypes``."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def launch(name: str, reads, writes, fn, *args) -> int:
    """``fn(*args)``, a bound C entry point's call, returning its error
    code. ``name`` is the kernel's, ``reads`` and ``writes`` the tensors it
    reads and writes, for the active accountant (none: neither is used)."""
    if ACCOUNTANT is None:
        return fn(*args)
    return ACCOUNTANT.launch(name, reads, writes, fn, *args)
