"""Full Assemble-ResNet-50 preset, field for field the reference's
``axcnn/configs/assemble_resnet50.py``: ResNet-D + SK + SE + BlurPool sconv
+ DropBlock + AutoAugment + mixup + label smoothing + cosine LR + EMA."""

from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.utils.config import Config, DataConfig, RuntimeConfig, TrainConfig


def get_config() -> Config:
    return Config(
        model=ModelConfig(
            resnet_size=50,
            use_resnet_d=True,
            use_se_block=True,
            use_sk_block=True,
            anti_alias_type="sconv",
            use_dropblock=True,
            dropblock_keep_prob=0.9,
            zero_gamma=True,
        ),
        data=DataConfig(
            dataset_name="imagenet",
            autoaugment_type="v0",
            mixup_alpha=0.2,
        ),
        train=TrainConfig(
            batch_size=1024,
            train_epochs=270,
            base_lr=0.1,
            lr_decay_type="cosine",
            lr_warmup_epochs=5.0,
            label_smoothing=0.1,
            weight_decay=1e-4,
            use_ema=True,
            ema_decay=0.9999,
            dtype="bf16",
        ),
        runtime=RuntimeConfig(),
    )
