"""Generate an ImageNet-C-layout corrupted benchmark from clean eval shards.

The reference's mCE evaluation assumes the pre-corrupted ImageNet-C tarballs
(~75 GB) are on disk (reference:eval protocol, SURVEY.md §3.4). This CLI makes
the benchmark self-contained: it reads clean validation TFRecords, applies the
clean-eval geometry (resize shorter side to ``resize_min``, central crop to
``image_size`` — corruption is defined on the *cropped* pixels, which is what
the standard 224x224 distribution stores), corrupts each image with
``axcnn_torch.data.corruptions`` (published Hendrycks & Dietterich
algorithms), and writes ``<output_dir>/<corruption>/<severity>/<prefix>-*``
shards in the exact layout ``axcnn_torch.eval.imagenet_c.run_imagenet_c``
consumes.

Labels/class-text/filenames are carried over unchanged. Images are re-encoded
as JPEG at ``--jpeg_quality`` (default 100, matching the distribution's JPEG
storage while adding minimal extra artifact; ``jpeg_compression``'s own
low-quality encode is already baked into its output pixels).

Determinism: each (corruption, severity, record) triple gets its own
``np.random.Generator`` seeded from ``--seed`` and the corruption's STABLE
index in ``CORRUPTION_FNS`` (not its position in the requested subset) —
output is independent of sharding, iteration order, and which subset of
corruptions a run requests, so any subset regenerates bit-identically.

The port of ``axcnn/data/build_imagenet_c.py``, over the port's own
TFRecord codec and preprocessing: the same shards, byte for byte, from the
same clean shards and seed.

Example:
    python -m axcnn_torch.data.build_imagenet_c \
        --data_dir=/data/imagenet/rec --output_dir=/data/imagenet_c \
        --corruptions=gaussian_noise,fog --severities=1,3,5
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import multiprocessing
import os

import numpy as np
from PIL import Image

from axcnn_torch.data.corruptions import CORRUPTION_FNS, corrupt
from axcnn_torch.data.preprocessing import preprocess_eval
from axcnn_torch.data.tfrecord import (TFRecordReader, TFRecordWriter,
                                 count_records, list_shards, make_example,
                                 parse_example)


def _encode_jpeg(img_u8: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def build_corrupted_set(data_dir: str, output_dir: str, *,
                        prefix: str = "validation", image_size: int = 224,
                        resize_min: int = 256, corruptions=None,
                        severities=(1, 2, 3, 4, 5), jpeg_quality: int = 100,
                        seed: int = 0, num_workers: int = 1,
                        progress=print) -> int:
    """Corrupt every record of ``<data_dir>/<prefix>-*`` for every
    (corruption, severity); returns total examples written.

    ``num_workers`` > 1 fans input shards out over a process pool; output
    is bit-identical at any worker count (per-record seeds are derived from
    the global record index, precomputed per shard)."""
    corruptions = list(corruptions or CORRUPTION_FNS)
    for name in corruptions:
        if name not in CORRUPTION_FNS:
            raise ValueError(f"unknown corruption {name!r}")
    shards = list_shards(data_dir, prefix)
    # each input shard is an independent work unit; per-record seeds use the
    # GLOBAL record index, so precompute every shard's record offset to keep
    # output bit-identical at any worker count
    offsets, off = [], 0
    for shard in shards:
        offsets.append(off)
        off += count_records(shard)
    for name in corruptions:
        for sev in severities:
            os.makedirs(os.path.join(output_dir, name, str(sev)),
                        exist_ok=True)
    tasks = [(shard, si, len(shards), offsets[si], output_dir, prefix,
              image_size, resize_min, corruptions, list(severities),
              jpeg_quality, seed) for si, shard in enumerate(shards)]
    if num_workers > 1:
        # spawned workers (the parent may hold threads, which fork does not
        # copy safely): corruption generation is pure numpy/scipy/PIL and a
        # full 15x5 build is hours of CPU on one core
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(num_workers, mp_context=ctx) as pool:
            counts = list(pool.map(_build_shard, tasks))
    else:
        counts = [_build_shard(t) for t in tasks]
    n_records = sum(counts)
    for name in corruptions:
        for sev in severities:
            progress(f"{name}/{sev}: {n_records} examples "
                     f"-> {os.path.join(output_dir, name, str(sev))}")
    return n_records * len(corruptions) * len(severities)


def _build_shard(task) -> int:
    """Corrupt one input shard into its per-(corruption, severity) output
    shards; returns the shard's record count. Module-level for pickling."""
    (shard, si, n_shards, rec_offset, output_dir, prefix, image_size,
     resize_min, corruptions, severities, jpeg_quality, seed) = task
    # seed by the corruption's stable position in CORRUPTION_FNS so a subset
    # run regenerates the same pixels as the full build
    stable_index = {n: i for i, n in enumerate(CORRUPTION_FNS)}
    n = 0
    # One decode+resize+crop per record, reused across all (corruption,
    # severity) outputs — a full build is 75 variants per record and the
    # clean-pixel preprocessing dominated generation time on a 1-core host.
    with contextlib.ExitStack() as stack:
        writers = {
            (name, sev): stack.enter_context(TFRecordWriter(os.path.join(
                output_dir, name, str(sev),
                f"{prefix}-{si:05d}-of-{n_shards:05d}")))
            for name in corruptions for sev in severities}
        for payload in TFRecordReader(shard):
            feats = parse_example(payload)
            clean = preprocess_eval(
                bytes(feats["image/encoded"][0]),
                image_size=image_size, resize_min=resize_min)
            out_feats = {k: v for k, v in feats.items()
                         if k != "image/encoded"}
            rec_idx = rec_offset + n
            for name in corruptions:
                for sev in severities:
                    rng = np.random.default_rng(
                        [seed, stable_index[name], sev, rec_idx])
                    bad = corrupt(clean, name, sev, rng)
                    out_feats["image/encoded"] = [
                        _encode_jpeg(bad, jpeg_quality)]
                    writers[(name, sev)].write(make_example(out_feats))
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", required=True,
                   help="directory with clean <prefix>-* TFRecord shards")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--prefix", default="validation")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--resize_min", type=int, default=256)
    p.add_argument("--corruptions", default=",".join(CORRUPTION_FNS),
                   help="comma-separated subset of the 15 corruption names")
    p.add_argument("--severities", default="1,2,3,4,5")
    p.add_argument("--jpeg_quality", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=1,
                   help="process-pool fan-out over input shards; output is "
                        "bit-identical at any worker count")
    args = p.parse_args(argv)
    n = build_corrupted_set(
        args.data_dir, args.output_dir, prefix=args.prefix,
        image_size=args.image_size, resize_min=args.resize_min,
        corruptions=[c for c in args.corruptions.split(",") if c],
        severities=[int(s) for s in args.severities.split(",") if s],
        jpeg_quality=args.jpeg_quality, seed=args.seed,
        num_workers=args.num_workers)
    print(f"wrote {n} corrupted examples to {args.output_dir}")


if __name__ == "__main__":
    main()
