"""Vanilla ResNet-50 preset, field for field the reference's
``axcnn/configs/vanilla_resnet50.py``."""

from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.utils.config import Config, DataConfig, RuntimeConfig, TrainConfig


def get_config() -> Config:
    return Config(
        model=ModelConfig(resnet_size=50),
        data=DataConfig(dataset_name="imagenet"),
        train=TrainConfig(
            batch_size=1024,
            train_epochs=90,
            base_lr=0.1,
            lr_decay_type="cosine",
            lr_warmup_epochs=5.0,
            label_smoothing=0.0,
            weight_decay=1e-4,
            dtype="bf16",
        ),
        runtime=RuntimeConfig(),
    )
