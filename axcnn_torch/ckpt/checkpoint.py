"""Checkpoint and resume of the whole training state (port of
``axcnn/ckpt/checkpoint.py``).

The reference's surface and payload: ``step``, the parameters (``params``),
the BN moving statistics (``model_state``), ``velocity``, ``ema`` (only
when on), ``rng_seed`` and the loader position (``loader_epoch``,
``loader_batches``), so a resume continues the data stream exactly. The
constructor writes the reference's architecture sidecar
``model_config.json`` (``dataclasses.asdict(ModelConfig)``), and
``max_to_keep`` keeps the newest checkpoints.

orbax needs jax, which the port never imports, so the format is the port's
own: one file per step, ``<dir>/<step>.pt``, a dict of the port's
``state_dict`` names written with ``torch.save`` to a temporary name and
then renamed, so a kill mid-save leaves the last good checkpoint. It is read
back with ``torch.load(..., weights_only=True)``: tensors, ints and dicts
only.

Saves are asynchronous, as orbax's are. ``save`` takes a snapshot of every
tensor of the payload in host memory (pinned, for a card's tensors; the
buffers are kept and reused by the next save) and waits for the copies, so
the optimizer and the EMA may update the live tensors in place as soon as
it returns; one writer thread then pickles, writes, fsyncs, renames and
applies the retention. At most one save is in flight: the next ``save``
joins it first, as do ``load``, ``restore``, ``wait`` and ``close``. An
exception in the writer (``KeyboardInterrupt`` included) is raised again
by the next call that joins it. ``all_steps`` and ``latest_step`` count an
in-flight step as written (and the steps its retention removes as gone),
so a step that is being written is never written again.

A checkpoint written by ``axcnn`` crosses through
``axcnn_torch.ckpt.convert.train_state_from_axcnn`` on a host with both
packages (README.md).
"""

from __future__ import annotations

import json
import os
import re
import threading

import torch

from axcnn_torch.ckpt.convert import _format
from axcnn_torch.data.pipeline import LoaderState
from axcnn_torch.models.resnet import ResNet

SIDECAR = "model_config.json"
_STEP_FILE = re.compile(r"(\d+)\.pt")
# the ModelConfig fields that name or shape the parameters, or change the
# eval forward: a checkpoint serves only a model that agrees on all of them
ARCH_FIELDS = ("resnet_size", "num_classes", "use_resnet_d", "use_se_block",
               "use_sk_block", "sk_merged_conv", "se_ratio", "anti_alias_type",
               "anti_alias_filter_size", "bl_alpha", "bl_beta", "width_multiplier")


def check_match(got: dict, want: dict, where: str) -> None:
    """Raise ``ValueError`` unless the tensors ``got`` have exactly the names
    and shapes of ``want`` (a dict of tensors or shapes)."""
    got_s = {k: tuple(v.shape) for k, v in got.items()}
    want_s = {k: tuple(getattr(v, "shape", v)) for k, v in want.items()}
    if got_s == want_s:
        return
    missing = sorted(set(want_s) - set(got_s))
    extra = sorted(set(got_s) - set(want_s))
    shape = sorted(k for k in set(want_s) & set(got_s) if want_s[k] != got_s[k])
    raise ValueError(f"{where} does not match the model: missing {missing[:5]}, "
                     f"unexpected {extra[:5]}, mis-shaped {shape[:5]} "
                     f"({len(missing)}/{len(extra)}/{len(shape)} in all)")


def arch_mismatch(meta: dict, model_cfg) -> dict:
    """``{field: (checkpoint's, model's)}`` for the ``ARCH_FIELDS`` on which a
    sidecar and a model config disagree."""
    out = {}
    for f in ARCH_FIELDS:
        mine = getattr(model_cfg, f)
        if f in meta and meta[f] != mine:
            out[f] = (meta[f], mine)
    return out


def load_weights(model, weights: dict, buffers: dict, where: str, *,
                 skip: tuple = ()) -> None:
    """Copy a checkpoint's ``weights`` (parameter names) and BN ``buffers``
    into ``model`` in place, each tensor keeping its device and memory
    format. Parameters whose names start with one of ``skip`` are left as
    they are. ``ValueError``, before anything is written, on any name or
    shape mismatch."""
    params = {k: p for k, p in model.named_parameters() if not k.startswith(skip)}
    weights = {k: v for k, v in weights.items() if not k.startswith(skip)}
    targets = dict(model.named_buffers())
    check_match(weights, params, where)
    check_match(buffers, targets, where)
    with torch.no_grad():
        for k, t in weights.items():
            params[k].copy_(t)
        for k, t in buffers.items():
            targets[k].copy_(t)


def model_from_payload(raw: dict, cfg, *, device, use_ema: bool = True,
                       where: str = "checkpoint"):
    """``ResNet(cfg)`` in eval mode on ``device``, channels_last, holding a
    checkpoint's weights (its EMA when ``use_ema`` and it has one, else its
    parameters) and BN statistics. Built on the meta device, so nothing is
    random-initialised first; ``ValueError`` on any name or shape mismatch."""
    with torch.device("meta"):
        model = ResNet(cfg)
    model = model.to_empty(device=device).to(memory_format=torch.channels_last)
    weights = raw["ema"] if use_ema and "ema" in raw else raw["params"]
    load_weights(model, weights, raw["model_state"], where)
    return model.eval()


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int | None = 5,
                 model_config: dict | None = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 or None, got {max_to_keep}")
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._writer: threading.Thread | None = None
        self._in_flight: int | None = None  # the step the writer is writing
        self._error: BaseException | None = None
        self._host: dict = {}  # snapshot buffers by payload path, reused
        if model_config is not None:
            os.makedirs(self._dir, exist_ok=True)
            self._write(SIDECAR, lambda f: f.write(
                json.dumps(model_config, indent=1, default=str).encode()))

    @property
    def directory(self) -> str:
        return self._dir

    def _write(self, name: str, write) -> None:
        """Write ``name`` through a temporary file and an atomic rename."""
        path = os.path.join(self._dir, name)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                write(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def _steps_on_disk(self) -> list[int]:
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.fullmatch,
                                                   os.listdir(self._dir)) if m)

    def all_steps(self) -> list[int]:
        """The steps on disk, and the one being written as if it were
        (after its retention)."""
        in_flight = self._in_flight
        steps = self._steps_on_disk()
        if in_flight is None:
            return steps
        steps = sorted(set(steps) | {in_flight})
        return steps if self._max_to_keep is None else steps[-self._max_to_keep:]

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, *, loader_state: LoaderState | None = None,
             rng_seed: int = 0, force: bool = False) -> bool:
        """Start writing ``state`` at its step; returns whether it does. As
        with orbax, a step already on disk is never rewritten, and a step
        before the latest is written only when ``force``. Joins the save in
        flight first; returns once the snapshot is taken."""
        self._join()
        step = int(state.step)
        latest = self.latest_step()
        if step in self.all_steps() or (not force and latest is not None
                                        and step < latest):
            return False
        model = state.model
        payload = self._snapshot({
            "params": {k: p.detach() for k, p in model.named_parameters()},
            "model_state": {k: b.detach() for k, b in model.named_buffers()},
            "velocity": state.velocity,
            **({"ema": state.ema} if state.ema is not None else {}),
        })
        payload.update(step=step, rng_seed=int(rng_seed),
                       loader_epoch=int(loader_state.epoch) if loader_state else 0,
                       loader_batches=int(loader_state.batches_yielded) if loader_state else 0)
        os.makedirs(self._dir, exist_ok=True)
        self._in_flight = step
        self._writer = threading.Thread(target=self._write_step, args=(step, payload),
                                        name="checkpoint-writer")
        self._writer.start()
        return True

    def _snapshot(self, tensors: dict) -> dict:
        """``{field: {name: tensor}}`` copied into this manager's host
        buffers (pinned for CUDA tensors), after the copies have finished."""
        out, cuda = {}, set()
        for field, d in tensors.items():
            out[field] = {}
            for k, t in d.items():
                buf = self._host.get((field, k))
                if (buf is None or buf.shape != t.shape or buf.dtype != t.dtype
                        or buf.stride() != t.stride()):
                    buf = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                              pin_memory=t.is_cuda)
                    self._host[(field, k)] = buf
                buf.copy_(t, non_blocking=t.is_cuda)
                if t.is_cuda:
                    cuda.add(t.device)
                out[field][k] = buf
        for device in cuda:
            torch.cuda.synchronize(device)
        return out

    def _write_step(self, step: int, payload: dict) -> None:
        """The writer thread: the file, then the retention."""
        try:
            self._write(os.path.basename(self.path(step)), lambda f: torch.save(payload, f))
            if self._max_to_keep is not None:
                for old in self._steps_on_disk()[:-self._max_to_keep]:
                    os.remove(self.path(old))
        except BaseException as exc:  # noqa: BLE001 - raised again by _join
            self._error = exc

    def _join(self) -> None:
        """Wait for the save in flight; raise its writer's exception."""
        if self._writer is not None:
            self._writer.join()
            self._writer = self._in_flight = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def model_config(self) -> dict | None:
        """The architecture sidecar written by the producing run, or None."""
        path = os.path.join(self._dir, SIDECAR)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def load(self, step: int | None = None, *, device="cpu") -> dict | None:
        """The raw payload of ``step`` (default: the latest) with its tensors
        on ``device``, or None when there is no checkpoint."""
        self._join()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=device, weights_only=True)

    def restore(self, state, *, step: int | None = None):
        """Fill ``state`` (a ``TrainState`` of the same model) from the
        checkpoint, in place, and return ``(state, LoaderState, rng_seed)``,
        or None when there is no checkpoint. Every tensor keeps the fresh
        state's device and memory format (4-D tensors channels_last). Raises
        ``ValueError``, before anything is written, when the checkpoint's
        names or shapes differ from the state's."""
        model = state.model
        device = next(model.parameters()).device
        raw = self.load(step, device=device)
        if raw is None:
            return None
        where = f"checkpoint {self.path(raw['step'])}"
        params = dict(model.named_parameters())
        check_match(raw["velocity"], params, f"{where} (velocity)")
        if (state.ema is None) != ("ema" not in raw):
            raise ValueError(
                f"{where} {'has no' if state.ema is not None else 'has an'} EMA "
                "but the state " + ("keeps one" if state.ema is not None
                                    else "keeps none") + " (train.use_ema)")
        if state.ema is not None:
            check_match(raw["ema"], params, f"{where} (EMA)")
        load_weights(model, raw["params"], raw["model_state"], where)

        def like_params(d):
            return {k: d[k].contiguous(memory_format=_format(d[k])) for k in params}

        state.velocity = like_params(raw["velocity"])
        state.ema = like_params(raw["ema"]) if state.ema is not None else None
        state.step = int(raw["step"])
        loader_state = LoaderState(epoch=int(raw["loader_epoch"]),
                                   batches_yielded=int(raw["loader_batches"]))
        return state, loader_state, int(raw["rng_seed"])

    def wait(self) -> None:
        """Wait until the save in flight is on disk."""
        self._join()

    def close(self) -> None:
        """Wait for the save in flight and release the snapshot buffers."""
        try:
            self._join()
        finally:
            self._host = {}
