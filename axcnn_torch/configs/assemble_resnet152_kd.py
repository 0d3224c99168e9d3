"""Assemble-ResNet-152 with knowledge distillation (BASELINE config 5),
field for field the reference's ``axcnn/configs/assemble_resnet152_kd.py``.
Set ``--train.kd_teacher_checkpoint`` to a trained run's checkpoints. On one
card the global batch of 1024 runs as micro-batches:
``--train.grad_accum_steps=8``. The reference's docstring records that the
KD term roughly halves the largest stable learning rate."""

from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.utils.config import Config, DataConfig, RuntimeConfig, TrainConfig


def get_config() -> Config:
    return Config(
        model=ModelConfig(
            resnet_size=152,
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
            dtype="bf16",
            kd_temp=1.0,
            kd_alpha=1.0,
        ),
        runtime=RuntimeConfig(),
    )
