"""The native loader's serial section on the host, and its feed to the card
(``scripts/loader_bench.py``).

    python -m axcnn_torch.cli.loader_bench [--n_images 4096] [--batch 128] [--batches 12]

The native pipeline is one Python producer thread (record framing, shuffle,
seed derivation, pointer marshalling) driving a GIL-free C++ decode pool
(``axcnn_torch/data/cpp_loader.py``). Throughput scales with cores until the
producer's serial section is the bottleneck; this measures that section:

- ``stub_producer_ips``: ``cpp_loader.decode_batch`` replaced by a no-op,
  the Python producer's rate alone, the ceiling any number of decode cores
  can reach; ``stub_with_marshal_ips``: the same with the pointer, size and
  seed marshalling of the C call kept;
- ``framing_stream_ips``: the shard stream alone; ``seed_us_per_record``:
  the per-record seed hash;
- ``real_ips_workers{k}``: the loader with ``k`` C++ decode threads, AA v0
  on the host, and from them ``serial_us_per_record``,
  ``decode_us_per_record_1core`` and ``projected_scaling_limit_cores``;
- ``multiproducer_stub_ips_p2``: two producer threads
  (``MultiProducerLoader``) with the stub, and the consumer's own section
  (``consumer_us_per_record``: queue pops against pre-filled queues) and
  ``consumer_scaling_limit_cores_vs_decode``;
- ``real_to_card_ips_workers{k}``: the loader at the most workers through
  ``device_prefetch`` to the card (left out under ``--cpu``), the one card
  term.

The data is ``make_data``'s: ``n_images`` JPEGs of 320x260 (random 13x16
bases, bilinear, quality 90), random labels of 1,000, seed 0, 4 TFRecord
shards; the same bytes as the reference script's generator, and the set
``echo_bench`` trains on. Prints one JSON line with every term, the host's
``host_cores`` (``os.cpu_count()``) and ``affinity_cores`` (the cores this
process may run on), and ``card`` (the ``nvidia-smi`` name and power
limit). ``--batches`` sets the measured batches of each real row (4x that
for the stub rows).

``--cpu`` leaves the card out (the tests); without it and without a card it
exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import io
import json
import os
import queue as queue_mod
import sys
import tempfile
import time

import numpy as np

from axcnn_torch.cli.profile_step import measurement_device

WORKERS = (1, 2, 4)  # the reference's decode-thread counts
CONSUMER_ITERS = 2000
DATA_DIR = os.path.join(tempfile.gettempdir(), "axcnn_loaderbench")


def make_data(data_dir, n_images, shards=4, size=(320, 260), quality=90):
    """``n_images`` generated JPEGs in ``shards`` TFRecord files under
    ``data_dir`` (skipped when its marker for ``n_images`` is there)."""
    from PIL import Image

    from axcnn_torch.data.tfrecord import TFRecordWriter, make_example

    marker = os.path.join(data_dir, f"ok-{n_images}")
    if os.path.exists(marker):
        return
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    per = n_images // shards
    for s in range(shards):
        with TFRecordWriter(os.path.join(data_dir, f"train-{s:05d}-of-{shards:05d}")) as w:
            for _ in range(per):
                base = rng.integers(0, 256, (13, 16, 3)).astype(np.uint8)
                img = Image.fromarray(base).resize(size, Image.BILINEAR)
                buf = io.BytesIO()
                img.save(buf, "JPEG", quality=quality)
                w.write(make_example({
                    "image/encoded": [buf.getvalue()],
                    "image/class/label": [int(rng.integers(0, 1000))],
                }))
    open(marker, "w").close()


def dataset_info(n_images):
    from axcnn_torch.data.datasets import DatasetInfo

    return DatasetInfo("bench", 1000, n_images, n_images, train_prefix="train",
                       eval_prefix="train")


def loader(data_dir, n_images, batch, workers, aa=True, image_size=224):
    from axcnn_torch.data.pipeline import TFRecordImageLoader

    return TFRecordImageLoader(
        data_dir, dataset_info(n_images), batch_size=batch, train=True, image_size=image_size,
        autoaugment_type="v0" if aa else "none", seed=1, num_workers=workers, use_native=True)


def stub_decode(payloads, *, image_size, resize_min, train, seeds, num_threads=8,
                dct_fast=False, aa_policy=-1):
    """``decode_batch`` with the decode left out: zeros."""
    n = len(payloads)
    return (np.zeros((n, image_size, image_size, 3), np.uint8), np.zeros((n,), np.int32), n)


def stub_marshal(payloads, *, image_size, resize_min, train, seeds, num_threads=8,
                 dct_fast=False, aa_policy=-1):
    """``stub_decode`` with the C call's argument marshalling kept."""
    n = len(payloads)
    if n and isinstance(payloads[0], np.ndarray):
        (ctypes.c_void_p * n)(*[p.ctypes.data for p in payloads])
        (ctypes.c_int64 * n)(*[p.size for p in payloads])
    else:
        (ctypes.c_char_p * n)(*payloads)
        (ctypes.c_int64 * n)(*[len(p) for p in payloads])
    np.ascontiguousarray(np.asarray(seeds, np.uint64))
    return stub_decode(payloads, image_size=image_size, resize_min=resize_min, train=train,
                       seeds=seeds)


def _rate(batches_iter, batches, *, warm=1):
    it = iter(batches_iter)
    for _ in range(warm):
        next(it)
    t0 = time.perf_counter()
    n = 0
    for _ in range(batches):
        n += next(it)["labels"].shape[0]
    return n / (time.perf_counter() - t0)


def measure(data_dir, n_images, batch, batches, device=None, image_size=224) -> dict:
    """Every term of the module docstring; ``device``: the card's, or None."""
    from axcnn_torch.data import cpp_loader
    from axcnn_torch.data import pipeline as pl

    cpp_loader.get_lib()
    out = {"host_cores": os.cpu_count(), "affinity_cores": len(os.sched_getaffinity(0))}
    real_decode = cpp_loader.decode_batch
    try:
        for key, stub in (("stub_producer_ips", stub_decode),
                          ("stub_with_marshal_ips", stub_marshal)):
            cpp_loader.decode_batch = stub
            out[key] = _rate(loader(data_dir, n_images, batch, 4, image_size=image_size),
                             batches * 4)
    finally:
        cpp_loader.decode_batch = real_decode

    ldr = loader(data_dir, n_images, batch, 1, image_size=image_size)
    t0 = time.perf_counter()
    n = sum(1 for _ in ldr._record_stream(0))
    out["framing_stream_ips"] = n / (time.perf_counter() - t0)

    idxs = np.arange(batch)
    t0 = time.perf_counter()
    for e in range(200):
        pl._record_seeds(1, e, idxs)
    out["seed_us_per_record"] = (time.perf_counter() - t0) / (200 * batch) * 1e6

    for k in WORKERS:
        out[f"real_ips_workers{k}"] = _rate(loader(data_dir, n_images, batch, k,
                                                   image_size=image_size), batches)
    s, d1 = out["stub_producer_ips"], out["real_ips_workers1"]
    out["serial_us_per_record"] = 1e6 / s
    out["decode_us_per_record_1core"] = 1e6 / d1 - 1e6 / s
    out["projected_scaling_limit_cores"] = (1e6 / d1 - 1e6 / s) / (1e6 / s)

    cpp_loader.decode_batch = stub_decode
    try:
        mp_kw = dict(num_producers=2, batch_size=batch, train=True, image_size=image_size,
                     autoaugment_type="v0", seed=1, num_workers=2, use_native=True)
        mp = pl.MultiProducerLoader(data_dir, dataset_info(n_images), **mp_kw)
        out["multiproducer_stub_ips_p2"] = _rate(mp, batches * 4)
        mp.close()
        # the consumer alone: its queues pre-filled, no producer threads
        batch0 = {"images": np.zeros((batch, 8, 8, 3), np.uint8),
                  "labels": np.zeros((batch,), np.int32)}
        mp2 = pl.MultiProducerLoader(data_dir, dataset_info(n_images), **mp_kw)
        mp2._spawn = lambda: None
        qs = [queue_mod.Queue() for _ in range(2)]
        for q in qs:
            for _ in range(CONSUMER_ITERS):
                q.put(batch0)
        mp2._queues, mp2._stop = qs, None
        it = iter(mp2)
        next(it)
        t0 = time.perf_counter()
        for _ in range(CONSUMER_ITERS - 2):
            next(it)
        dt = time.perf_counter() - t0
        out["consumer_us_per_record"] = dt / ((CONSUMER_ITERS - 2) * batch) * 1e6
        out["consumer_scaling_limit_cores_vs_decode"] = (
            out["decode_us_per_record_1core"] / max(out["consumer_us_per_record"], 1e-9))
    finally:
        cpp_loader.decode_batch = real_decode

    if device is not None:
        k = WORKERS[-1]
        feed = pl.device_prefetch(iter(loader(data_dir, n_images, batch, k,
                                              image_size=image_size)), device=device, size=4)
        try:
            out[f"real_to_card_ips_workers{k}"] = _rate(_synced(feed), batches)
        finally:
            feed.close()
    return out


def _synced(feed):
    """The card's batches, each waited for on the host."""
    import torch

    for b in feed:
        torch.cuda.current_stream().synchronize()
        yield b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_dir", default=DATA_DIR)
    ap.add_argument("--n_images", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="leave the card out (tests)")
    args = ap.parse_args(argv)
    picked = measurement_device(args.cpu, "loader_bench")
    if picked is None:
        return 1
    device, card = picked
    make_data(args.data_dir, args.n_images)
    out = measure(args.data_dir, args.n_images, args.batch, args.batches,
                  device if device.type == "cuda" else None, args.image_size)
    print(json.dumps({**out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
