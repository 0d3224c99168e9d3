"""Host input pipeline: sharded TFRecords → uint8 host batches.

The port's own copy of ``axcnn/data/pipeline.py``: ``LoaderState``,
``TFRecordImageLoader``, ``SyntheticLoader``, ``MultiProducerLoader`` and
``EchoIterator``, unchanged; ``DevicePrefetch`` / ``device_prefetch`` in
torch terms (pinned host memory, a side stream on the card).

Parity target: the reference's tf.data ``input_fn`` (SURVEY.md §3.1):
  list shards → shuffle files → parallel interleave → shuffle records →
  parse → decode/augment (parallel) → batch.

Design:
- **per-host sharding** (SURVEY.md §5.8): host ``h`` of ``H`` reads shard
  files ``h, h+H, h+2H, ...`` — disjoint by construction, no coordination.
- **uint8 on the wire**: decode/crop/flip/AutoAugment on host threads,
  normalize/mixup on device inside the train step. H2D ships uint8 NHWC.
- **checkpointable position** (fixes the reference's silent tf.data state
  loss on resume, SURVEY.md §5.3): iteration order is a pure function of
  (seed, epoch); the loader state is just ``(epoch, batches_yielded)`` and
  restore = deterministic skip without decoding.

The C++ loader (cpp/) replaces the decode threads on the perf path; this
module is the semantics reference and bootstrap.
"""

from __future__ import annotations

import collections
import itertools
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from axcnn_torch.data.datasets import DatasetInfo
from axcnn_torch.data.preprocessing import preprocess_train, preprocess_eval
from axcnn_torch.data.autoaugment import make_autoaugment
from axcnn_torch.data.tfrecord import (TFRecordReader, MmapShardReader,
                                 parse_example, list_shards, count_records)

LoaderState = collections.namedtuple("LoaderState", ["epoch", "batches_yielded"])


def _splitmix64(z):
    """Vectorized splitmix64 finalizer (uint64 in/out; wraparound is the
    point of the hash, so the overflow warning is suppressed)."""
    with np.errstate(over="ignore"):
        z = np.asarray(z, np.uint64)
        z = (z + np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _record_seeds(seed: int, epoch: int, idxs) -> np.ndarray:
    """Per-record uint64 seeds for the native decoder, deterministic in
    (seed, epoch, record_index). One vectorized hash per batch — the round-2
    per-record ``np.random.SeedSequence`` construction was a measured
    serial-section term of the producer thread (~8 us/record)."""
    # hash the full seed through splitmix64 before mixing in the epoch —
    # an affine mix of (seed | 1) aliased every even seed with its odd
    # successor, so seed sweeps shared half their augmentation streams
    with np.errstate(over="ignore"):
        base = _splitmix64(_splitmix64(np.uint64(seed & (2**64 - 1)))
                           + np.uint64(epoch & (2**64 - 1)))
        return _splitmix64(base + np.asarray(idxs, np.uint64))


class TFRecordImageLoader:
    """Streams (images uint8 [B,H,W,3], labels int32 [B]) batches."""

    def __init__(
        self,
        data_dir: str,
        info: DatasetInfo,
        *,
        batch_size: int,
        train: bool,
        image_size: int = 224,
        resize_min: int = 256,
        autoaugment_type: str = "none",
        dct_method: str = "INTEGER_ACCURATE",
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        num_workers: int = 8,
        shuffle_buffer: int = 4096,
        drop_remainder: bool = True,
        use_native: bool = False,
    ):
        prefix = info.train_prefix if train else info.eval_prefix
        all_shards = list_shards(data_dir, prefix)
        self._shards = all_shards[host_id::num_hosts]
        # an eval with more hosts than files (8 ranks on a set of 2
        # validation files): every host reads every file and keeps every
        # num_hosts-th record, so each record is evaluated once
        self._records = slice(None)
        if not train and len(all_shards) < num_hosts:
            self._shards, self._records = all_shards, slice(host_id, None, num_hosts)
        if not self._shards:
            raise ValueError(f"host {host_id}/{num_hosts} got no shards")
        self._info = info
        self._bs = batch_size
        self._train = train
        self._image_size = image_size
        self._resize_min = resize_min
        self._aa = make_autoaugment(autoaugment_type) if train else None
        if dct_method not in ("INTEGER_ACCURATE", "INTEGER_FAST"):
            raise ValueError(f"unknown dct_method {dct_method!r}")
        if dct_method == "INTEGER_FAST" and not use_native:
            # PIL exposes no IDCT-method knob (always islow); fast IDCT is a
            # native-loader capability — it changes pixels, so fail loudly
            # rather than silently decode differently than requested
            raise ValueError(
                "dct_method=INTEGER_FAST requires the native loader "
                "(data.loader='cpp'); the PIL path always decodes "
                "INTEGER_ACCURATE")
        self._dct_fast = dct_method == "INTEGER_FAST"
        self._seed = seed
        self._workers = num_workers
        self._shuffle_buffer = shuffle_buffer
        self._drop_remainder = drop_remainder
        # native (C++) decode path: Example parse + JPEG decode + crop/resize
        # + AutoAugment in cpp/loader.cpp + cpp/autoaugment.cpp — the full
        # train-path preprocessing runs GIL-free in the native thread pool
        # (the reference's tf.data C++ map equivalent, SURVEY.md §2.9).
        self._native = bool(use_native)
        self._aa_policy = -1
        if self._native:
            from axcnn_torch.data import cpp_loader

            self._cpp = cpp_loader
            cpp_loader.get_lib()  # build/load eagerly so failures are loud
            policy_name = autoaugment_type if (train and self._aa) else "none"
            aa_policy = cpp_loader.AA_POLICIES.get(policy_name)
            if aa_policy is None:
                import warnings

                warnings.warn(
                    f"native loader has no AutoAugment policy "
                    f"{policy_name!r}; using the Python decode path")
                self._native = False
            else:
                self._aa_policy = aa_policy
        if self._dct_fast and not self._native:
            raise ValueError(
                "dct_method=INTEGER_FAST is only available on the native "
                "decode path (it maps to libjpeg JDCT_IFAST); this "
                "configuration fell back to PIL")
        self.state = LoaderState(epoch=0, batches_yielded=0)
        # framing-scan results; shards are immutable
        self._num_batches = self._num_records = None

    @property
    def native_active(self) -> bool:
        """True when the C++ decode path is actually in use (``use_native=True``
        can silently fall back to PIL for an unsupported AutoAugment policy —
        drive scripts that require the native path should assert on this)."""
        return self._native

    @property
    def image_size(self) -> int:
        return self._image_size

    def num_batches(self) -> int:
        """Batches per epoch for THIS host's shard subset (framing scan, no
        decode; cached — shard files are immutable, and multi-host eval calls
        this every eval cycle). Multi-host eval uses this to agree on a global
        batch count — hosts with fewer records pad, so the per-batch psum
        never deadlocks."""
        if self._num_batches is None:
            n = self.num_records()
            self._num_batches = (n // self._bs if self._drop_remainder
                                 else -(-n // self._bs))
        return self._num_batches

    def num_records(self) -> int:
        """Records in THIS host's shard subset (framing scan, cached)."""
        if self._num_records is None:
            total = sum(count_records(p) for p in self._shards)
            self._num_records = len(range(total)[self._records])
        return self._num_records

    # -- deterministic record stream for (seed, epoch) ----------------------
    def _record_stream(self, epoch: int):
        rng = np.random.default_rng((self._seed, epoch))
        shards = list(self._shards)
        # native path: zero-copy np.uint8 views over the shard mmap (the C++
        # decoder reads payloads in place; one unpack+slice of Python work
        # per record). PIL path keeps bytes payloads (parse_example input).
        reader = MmapShardReader if self._native else TFRecordReader
        if self._train:
            rng.shuffle(shards)
            buf = []
            for path in shards:
                for payload in reader(path):
                    buf.append(payload)
                    if len(buf) >= self._shuffle_buffer:
                        idx = int(rng.integers(0, len(buf)))
                        buf[idx], item = buf[-1], buf[idx]
                        buf.pop()
                        yield item
            rng.shuffle(buf)
            yield from buf
        else:
            yield from itertools.islice(
                itertools.chain.from_iterable(reader(path) for path in shards),
                self._records.start, None, self._records.step)

    def _prepare(self, payload, rng_seed):
        if not isinstance(payload, bytes):  # mmap view (native-path fallback)
            payload = bytes(payload)
        feats = parse_example(payload)
        image_bytes = feats["image/encoded"][0]
        label = int(feats["image/class/label"][0])
        if self._train:
            rng = np.random.default_rng(rng_seed)
            img = preprocess_train(image_bytes, rng,
                                   image_size=self._image_size,
                                   autoaugment_fn=self._aa)
        else:
            img = preprocess_eval(image_bytes, image_size=self._image_size,
                                  resize_min=self._resize_min)
        return img, label

    def _flush_native(self, items, epoch):
        payloads = [p for p, _ in items]
        seeds = _record_seeds(self._seed, epoch, [idx for _, idx in items])
        imgs, labels, ok = self._cpp.decode_batch(
            payloads, image_size=self._image_size, resize_min=self._resize_min,
            train=self._train, seeds=seeds, num_threads=self._workers,
            dct_fast=self._dct_fast, aa_policy=self._aa_policy)
        if ok != len(items):
            # records the native decoder can't handle (non-JPEG encodings from
            # build_tfrecords' .png/.bmp support, corrupt payloads) come back
            # as zeros/label -1: re-decode those slots via the PIL path, which
            # handles every format — and raises loudly if the record is truly
            # corrupt instead of training on zero images
            if self._dct_fast:
                # the PIL fallback always decodes INTEGER_ACCURATE — silently
                # mixing it into an INTEGER_FAST run is exactly the pixel
                # divergence the dct_method guards exist to prevent
                raise ValueError(
                    f"{len(items) - ok} record(s) the native JDCT_IFAST "
                    "decoder cannot handle (non-JPEG or corrupt); the PIL "
                    "fallback would decode INTEGER_ACCURATE — rebuild the "
                    "records as JPEG or use dct_method=INTEGER_ACCURATE")
            for i in np.flatnonzero(labels == -1):
                img, label = self._prepare(items[i][0],
                                           (self._seed, epoch, int(items[i][1])))
                imgs[i] = img
                labels[i] = label
        return {"images": imgs, "labels": labels}

    def _check_labels(self, batch):
        """Fail loudly on out-of-range labels (e.g. records built with the
        ImageNet background offset for an N-way FGVC head): a bad label would
        otherwise be silently clipped by take_along_axis inside the jitted
        loss and corrupt training for that class."""
        labels = batch["labels"]
        n = self._info.num_classes
        if labels.size and (labels.min() < 0 or labels.max() >= n):
            bad = labels[(labels < 0) | (labels >= n)][:8]
            raise ValueError(
                f"labels out of range for {self._info.name} "
                f"(num_classes={n}): {bad.tolist()} — were the TFRecords "
                f"built with the wrong --label_offset?")
        return batch

    def __iter__(self):
        if not self._train:
            # an eval pass is stateless: always start from the top, even if a
            # previous iteration was abandoned mid-pass (exception / consumer
            # break) — a mid-pass state left behind would silently skip the
            # already-yielded batches and undercount the next eval's metrics
            self.state = LoaderState(epoch=0, batches_yielded=0)
        elif self._drop_remainder and self.num_batches() == 0:
            # every epoch would end before its first batch, and the loop
            # below would scan empty epochs forever
            raise ValueError(
                f"{self.num_records()} training record(s) in {self._info.name}'s "
                f"shards cannot fill one batch of {self._bs} (drop_remainder): "
                "add records or lower the batch")
        epoch = self.state.epoch
        skip = self.state.batches_yielded  # deterministic resume
        while True:
            stream = self._record_stream(epoch)
            batch_idx = 0
            pending = []
            with ThreadPoolExecutor(self._workers) as pool:
                def flush(items):
                    if self._native:
                        return self._flush_native(items, epoch)
                    futures = [
                        pool.submit(self._prepare, payload,
                                    (self._seed, epoch, idx))
                        for payload, idx in items
                    ]
                    imgs = np.stack([f.result()[0] for f in futures])
                    labels = np.asarray([f.result()[1] for f in futures], np.int32)
                    return {"images": imgs, "labels": labels}

                for rec_idx, payload in enumerate(stream):
                    # resume: skip whole batches without decoding
                    if batch_idx < skip:
                        if (rec_idx + 1) % self._bs == 0:
                            batch_idx += 1
                        continue
                    pending.append((payload, rec_idx))
                    if len(pending) == self._bs:
                        batch = self._check_labels(flush(pending))
                        pending = []
                        # state is advanced BEFORE the yield: once the consumer
                        # holds batch N, state records N batches delivered
                        # (statements after a yield only run on the next next()).
                        batch_idx += 1
                        self.state = LoaderState(epoch, batch_idx)
                        yield batch
                if pending and not self._drop_remainder:
                    batch_idx += 1
                    self.state = LoaderState(epoch, batch_idx)
                    yield self._check_labels(flush(pending))
            if not self._train:
                # an eval loader is a stateless full pass: reset so the NEXT
                # iteration replays the whole set (run() reuses one eval
                # loader across periodic evals — leaving state at
                # (0, num_batches) made every eval after the first skip
                # everything and report empty metrics)
                self.state = LoaderState(epoch=0, batches_yielded=0)
                return
            epoch += 1
            skip = 0
            self.state = LoaderState(epoch, 0)


class SyntheticLoader:
    """The reference's ``--use_synthetic_data`` equivalent: fixed random
    batches straight from memory, for perf isolation of the compute path."""

    def __init__(self, *, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0, num_batches=None):
        rng = np.random.default_rng(seed)
        self._batch = {
            "images": rng.integers(0, 256, (batch_size, image_size, image_size, 3),
                                   dtype=np.uint8),
            "labels": rng.integers(0, num_classes, (batch_size,), dtype=np.int32),
        }
        self._num = num_batches
        self.state = LoaderState(epoch=0, batches_yielded=0)

    def __iter__(self):
        i = 0
        while self._num is None or i < self._num:
            yield self._batch
            i += 1


class MultiProducerLoader:
    """Scale-out of the host input pipeline ONTO host cores: ``P`` producer
    threads, each a full :class:`TFRecordImageLoader` over a disjoint shard
    subset, interleaved round-robin (the reference's tf.data
    ``parallel_interleave(cycle_length=P)`` equivalent, SURVEY.md §3.1).

    **Virtual-host composition**: producer ``p`` runs with
    ``host_id = host_id*P + p, num_hosts = num_hosts*P`` — the existing
    per-host shard sharding (disjoint by construction) does the work, so a
    producer IS a loader and inherits every semantics guarantee (seeded
    shuffle, native decode, label checks). Producer streams are seeded
    independently (seed folded with the producer index) so augmentation
    never duplicates across producers.

    **Why**: the single-stream loader has a measured ~12.5 us/record serial
    section (docs/SCALING.md) — an Amdahl ceiling near ~120 host cores.
    Here that term moves INTO the producers; the consumer's serial work is
    one queue pop per BATCH, measured at sub-microsecond per record
    (scripts/loader_bench.py --producers), so the host ceiling becomes
    decode-thread count, not stream framing.

    **Exact resume**: the state is ``LoaderState(epoch, batches_yielded)``
    with the GLOBAL round-robin batch count; producer positions derive from
    it exactly (producer p has yielded ``n//P + (p < n%P)`` batches, and
    with ``drop_remainder`` its per-epoch batch count is a constant, so its
    own (epoch, skip) state is ``divmod``). Requires ``drop_remainder``
    (train default) — without it the derivation would need per-producer
    remainders.

    Ordering differs from the single-stream loader (as with tf.data's
    parallel interleave) but is bit-deterministic in (seed, epoch, P).
    """

    def __init__(self, data_dir, info, *, num_producers: int,
                 host_id: int = 0, num_hosts: int = 1, seed: int = 0,
                 queue_depth: int = 2, **loader_kw):
        if num_producers < 2:
            raise ValueError("use TFRecordImageLoader for a single producer")
        if not loader_kw.get("train", False):
            raise ValueError("multi-producer mode is a train-path feature "
                             "(eval is a stateless single pass)")
        if not loader_kw.get("drop_remainder", True):
            raise ValueError("multi-producer resume needs drop_remainder")
        self._P = num_producers
        self._depth = queue_depth
        n_shards = len(list_shards(data_dir, info.train_prefix)
                       [host_id::num_hosts])
        if n_shards < num_producers:
            raise ValueError(
                f"num_producers={num_producers} needs at least that many "
                f"shard files on this host (host {host_id} of {num_hosts} "
                f"has {n_shards}) — rebuild with more shards or lower "
                "--data.num_producers")
        self._producers = [
            TFRecordImageLoader(
                data_dir, info,
                host_id=host_id * num_producers + p,
                num_hosts=num_hosts * num_producers,
                # producer 0 keeps the caller's seed; the rest fold their
                # index through the same hash the record seeds use
                seed=seed if p == 0 else int(_splitmix64(
                    _splitmix64(np.uint64(seed & (2**64 - 1)))
                    + np.uint64(p))),
                **loader_kw)
            for p in range(num_producers)
        ]
        self._threads = []
        self._stop = None
        self.state = LoaderState(epoch=0, batches_yielded=0)

    @property
    def native_active(self) -> bool:
        return all(ld.native_active for ld in self._producers)

    @property
    def image_size(self) -> int:
        return self._producers[0].image_size

    def num_batches(self) -> int:
        return sum(ld.num_batches() for ld in self._producers)

    def _spawn(self):
        # (re)start producer threads from the current global state
        stop = threading.Event()
        queues = [queue_mod.Queue(maxsize=self._depth) for _ in self._producers]
        n = self.state.batches_yielded

        def run_producer(p, ld, q):
            per_epoch = ld.num_batches()
            yielded = n // self._P + (1 if p < n % self._P else 0)
            ld.state = LoaderState(*divmod(yielded, per_epoch))
            try:
                for batch in ld:
                    # bounded put that honors stop (no daemon-thread leak
                    # blocked on a full queue after the consumer moves on)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.5)
                            break
                        except queue_mod.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as exc:  # noqa: BLE001 — forwarded below
                q.put(exc)

        threads = [
            threading.Thread(target=run_producer, args=(p, ld, q), daemon=True)
            for p, (ld, q) in enumerate(zip(self._producers, queues))
        ]
        for t in threads:
            t.start()
        self._stop, self._threads, self._queues = stop, threads, queues

    def close(self):
        if self._stop is not None:
            self._stop.set()

    def __iter__(self):
        self.close()  # retire threads from any previous iteration
        self._spawn()
        while True:
            n = self.state.batches_yielded
            item = self._queues[n % self._P].get()
            if isinstance(item, BaseException):
                raise RuntimeError("multi-producer loader thread failed") \
                    from item
            # state advances BEFORE the yield, same contract as the
            # single-stream loader (the consumer holding batch N means N
            # batches delivered)
            self.state = LoaderState(
                epoch=(n + 1) // max(self.num_batches(), 1),
                batches_yielded=n + 1)
            yield item


class EchoIterator:
    """Data echoing (Choi et al. 2019): yield each upstream item ``factor``
    times. Wrapped AROUND DevicePrefetch so the echoed batch is already on
    device — host decode, augment, and transfer all drop to 1/factor while
    the chip sees a batch every step. Per-step randomness (mixup, DropBlock,
    device AutoAugment) is folded from the step index inside the train step,
    so echoed steps are not identical replays.

    ``consumed_state`` passes through from the wrapped iterator and only
    advances when a FRESH batch is pulled — so it is only step-consistent at
    echo-group boundaries (``at_boundary``). The run loop defers checkpoint
    saves to the next boundary (≤ factor-1 steps), which makes resume EXACT:
    a resumed run replays the identical batch/step stream an uninterrupted
    run would have seen (pinned bitwise by
    tests/test_loop.py::test_echo_resume_matches_uninterrupted).
    """

    def __init__(self, iterator, factor: int):
        if factor < 1:
            raise ValueError(f"echo_factor must be >= 1, got {factor}")
        self._it = iter(iterator)
        self._inner = iterator
        self._factor = factor
        self._left = 0
        self._batch = None

    @property
    def consumed_state(self):
        return getattr(self._inner, "consumed_state", None)

    @property
    def at_boundary(self) -> bool:
        """True when the held batch is fully echoed — every fresh batch in
        ``consumed_state`` got exactly ``factor`` steps, so a checkpoint
        taken now resumes the stream exactly."""
        return self._left == 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._left == 0:
            self._batch = next(self._it)
            self._left = self._factor
        self._left -= 1
        return self._batch


class DevicePrefetch:
    """Background-thread device prefetch: keeps ``size`` batches in flight.

    A producer thread pulls host batches (dicts of numpy arrays or CPU
    tensors) from ``iterator`` and moves them to ``device``. On the card each
    batch is copied from pinned host memory on a side stream; the consumer's
    stream waits on the copy's event, and each tensor is ``record_stream``-ed
    on it for the caching allocator. On the CPU the tensors are handed over
    as they are.

    Producer-thread failures are re-raised in the consumer (not swallowed):
    a decode error must kill training / eval loudly, never truncate it.

    ``state_fn`` (optional) snapshots the source loader's checkpoint state
    right after each batch is pulled from ``iterator``; the snapshot for the
    batch the consumer is currently holding is exposed as
    ``.consumed_state``. This is what checkpoints must record: the loader's
    own ``.state`` runs up to ``size``+1 batches AHEAD (the producer thread
    advances it), and saving it would silently skip those batches on resume.

    ``close()`` stops the producer; a consumer that stops early calls it.
    """

    _END = object()

    def __init__(self, iterator, *, device, size: int = 2, state_fn=None):
        if size < 1:
            raise ValueError(f"data.prefetch must be >= 1, got {size}")
        device = torch.device(device)
        self._device = device
        self.consumed_state = None
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
        self._stop = threading.Event()
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None

        def put(item):
            # bounded put that honors stop: no thread left blocked on a full
            # queue after the consumer has gone
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    return
                except queue_mod.Full:
                    continue

        def producer():
            try:
                if stream is not None:
                    torch.cuda.set_device(device)
                for batch in iterator:
                    state = state_fn() if state_fn is not None else None
                    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
                    event = None
                    if stream is not None:
                        with torch.cuda.stream(stream):
                            batch = {k: v.pin_memory().to(device, non_blocking=True)
                                     for k, v in batch.items()}
                            event = torch.cuda.Event()
                            event.record(stream)
                    put((batch, event, state))
                    if self._stop.is_set():
                        return
            except BaseException as exc:  # noqa: BLE001 — forwarded, not dropped
                put(exc)
            else:
                put(self._END)

        self._thread = threading.Thread(target=producer, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise RuntimeError("data pipeline producer thread failed") from item
        batch, event, state = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for v in batch.values():
                v.record_stream(current)
        if state is not None:
            self.consumed_state = state
        return batch

    def close(self):
        """Stop the producer and wait for it (it notices within 0.5 s)."""
        self._stop.set()
        while True:  # unblock a put in progress
            try:
                self._q.get_nowait()
            except queue_mod.Empty:
                break
        self._thread.join(timeout=5)


def device_prefetch(iterator, *, device, size: int = 2, state_fn=None):
    """See DevicePrefetch; function form kept as the call-site spelling."""
    return DevicePrefetch(iterator, device=device, size=size, state_fn=state_fn)
