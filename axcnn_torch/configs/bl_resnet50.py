"""Big-Little ResNet-50 preset (bL-Net: alpha=2, beta=4, ResNet-D,
zero-gamma, AutoAugment v0, mixup 0.2, bf16), field for field the
reference's ``axcnn/configs/bl_resnet50.py``: the speed-oriented preset
beside ``assemble_resnet50``. Stages 2-3 are Big-Little stages
(``axcnn_torch.models.resnet.BLStage``)."""

from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.utils.config import Config, DataConfig, RuntimeConfig, TrainConfig


def get_config() -> Config:
    return Config(
        model=ModelConfig(
            resnet_size=50,
            bl_alpha=2,
            bl_beta=4,
            use_resnet_d=True,
            zero_gamma=True,
        ),
        data=DataConfig(
            dataset_name="imagenet",
            autoaugment_type="v0",
            mixup_alpha=0.2,
        ),
        train=TrainConfig(
            batch_size=1024,
            train_epochs=120,
            base_lr=0.1,
            lr_decay_type="cosine",
            lr_warmup_epochs=5.0,
            label_smoothing=0.1,
            weight_decay=1e-4,
            use_ema=True,
            dtype="bf16",
        ),
        runtime=RuntimeConfig(),
    )
