"""FGVC transfer-learning fine-tune preset, field for field the reference's
``axcnn/configs/finetune_fgvc.py``: warm-start every weight except the head
from a pretrained Assemble-ResNet checkpoint, short schedule, low LR.

    --data.dataset_name=food101 --train.pretrained_checkpoint=<ckpt_dir>
"""

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
            dataset_name="food101",
            autoaugment_type="v0",
            mixup_alpha=0.2,
        ),
        train=TrainConfig(
            batch_size=256,
            train_epochs=40,
            base_lr=0.01,
            lr_decay_type="cosine",
            lr_warmup_epochs=2.0,
            label_smoothing=0.1,
            weight_decay=1e-4,
            use_ema=True,
            dtype="bf16",
            warm_start_exclude_head=True,
        ),
        runtime=RuntimeConfig(),
    )
