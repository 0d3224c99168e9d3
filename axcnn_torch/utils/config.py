"""Config system (port of ``axcnn/utils/config.py``).

The same four dataclasses with the same field names and defaults (the model
section is ``axcnn_torch.models.resnet.ModelConfig``), the same presets and
the same CLI grammar: ``--field=value`` or ``--section.field=value``;
unprefixed names resolve if unambiguous; ``--config=name`` loads a preset
from ``axcnn_torch/configs`` first, then overrides apply left to right.
tests/test_torch_config.py keeps the fields from drifting from the
reference's. Fields of features the port does not have yet are parsed and
kept, so one command line serves both packages.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Sequence

from axcnn_torch.models.resnet import ModelConfig


@dataclasses.dataclass
class DataConfig:
    dataset_name: str = "imagenet"
    data_dir: str = ""
    use_synthetic_data: bool = False
    preprocessing_type: str = ""  # 'imagenet_<size>_<min>[a]' or ''
    image_size: int = 224
    resize_min: int = 256
    dct_method: str = "INTEGER_ACCURATE"
    autoaugment_type: str = "none"  # none | v0 | imagenet
    autoaugment_device: bool = False
    aa_num_groups: int = 8
    mixup_alpha: float = 0.0
    mixup_per_shard: bool = False
    mixup_symmetric: bool = False
    num_workers: int = 8
    num_producers: int = 1
    shuffle_buffer: int = 4096
    prefetch: int = 2
    loader: str = "python"  # python | cpp
    echo_factor: int = 1
    # dataset_name="custom": user-built TFRecord sets
    num_classes: int = 0
    num_train_examples: int = 0
    num_eval_examples: int = 0
    label_offset: int = 0


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 256  # global batch
    grad_accum_steps: int = 1
    train_epochs: int = 90
    train_steps: int = 0
    epochs_between_evals: int = 1
    stop_threshold: float = 0.0
    base_lr: float = 0.1  # per 256, scaled linearly by global batch
    lr_decay_type: str = "cosine"  # cosine | step | constant
    lr_warmup_epochs: float = 5.0
    momentum: float = 0.9
    weight_decay: float = 1e-4
    label_smoothing: float = 0.1
    use_ema: bool = False
    ema_decay: float = 0.9999
    dtype: str = "bf16"  # bf16 | fp32
    seed: int = 42
    log_every: int = 100
    kd_teacher_checkpoint: str = ""
    kd_teacher_resnet_size: int = 0
    kd_teacher_use_resnet_d: str = ""
    kd_teacher_use_se_block: str = ""
    kd_teacher_use_sk_block: str = ""
    kd_teacher_anti_alias_type: str = "inherit"
    kd_temp: float = 1.0
    kd_alpha: float = 1.0
    pretrained_checkpoint: str = ""
    warm_start_exclude_head: bool = True


@dataclasses.dataclass
class RuntimeConfig:
    model_dir: str = "/tmp/axcnn_model"
    save_checkpoint_steps: int = 0
    keep_checkpoint_max: int = 5
    num_devices: int = 0
    platform: str = ""
    spatial_partitions: int = 1
    dcn_slices: int = 0
    hang_watchdog_s: int = 0
    profile_steps: int = 0
    tensorboard: bool = False
    eval_only: bool = False
    eval_imagenet_c: bool = False
    export_dir: str = ""


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_SECTIONS = ("model", "data", "train", "runtime")


def _parse_value(raw: str, typ) -> Any:
    if typ is bool:
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"bad bool {raw!r}")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    if typ is str:
        return raw
    # tuples (e.g. dropblock_stages): comma-separated ints
    return tuple(int(x) for x in raw.split(",") if x)


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``--a.b=v`` / ``--b=v`` strings; returns a new Config."""
    fields = {(s, f.name) for s in _SECTIONS
              for f in dataclasses.fields(getattr(cfg, s))}
    sections = {s: {} for s in _SECTIONS}
    for item in overrides:
        if not item.startswith("--"):
            raise ValueError(f"override must start with --: {item!r}")
        body = item[2:]
        if "=" not in body:
            body += "=true"  # bare flag = bool true
        name, raw = body.split("=", 1)
        if "." in name:
            section, fname = name.split(".", 1)
            if (section, fname) not in fields:
                raise ValueError(f"unknown config field {name!r}")
        else:
            matches = [(s, f) for (s, f) in fields if f == name]
            if not matches:
                raise ValueError(f"unknown config field {name!r}")
            if len(matches) > 1:
                raise ValueError(
                    f"ambiguous field {name!r} (in {sorted(s for s, _ in matches)}); "
                    f"qualify as --section.{name}")
            section, fname = matches[0]
        current = getattr(getattr(cfg, section), fname)
        sections[section][fname] = _parse_value(raw, type(current))
    return Config(**{s: dataclasses.replace(getattr(cfg, s), **sections[s])
                     for s in _SECTIONS})


def load_preset(name: str) -> Config:
    """Load ``axcnn_torch/configs/<name>.py`` (defines ``get_config()``)."""
    return importlib.import_module(f"axcnn_torch.configs.{name}").get_config()


def parse_cli(argv: Sequence[str]) -> Config:
    """argv: everything after the program name."""
    preset = None
    overrides = []
    for a in argv:
        if a.startswith("--config="):
            preset = a.split("=", 1)[1]
        elif a in ("-h", "--help"):
            _print_help()
            raise SystemExit(0)
        else:
            overrides.append(a)
    cfg = load_preset(preset) if preset else Config()
    return apply_overrides(cfg, overrides)


def _print_help():
    cfg = Config()
    print(__doc__)
    for section in _SECTIONS:
        sub = getattr(cfg, section)
        print(f"\n[{section}]")
        for f in dataclasses.fields(sub):
            print(f"  --{section}.{f.name}  (default: {getattr(sub, f.name)!r})")
