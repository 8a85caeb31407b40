"""ResNet-18 / ImageNet — the paper's own benchmark model (He et al. 2015)."""
from repro_torch.config import ModelConfig, register_arch

NAME = "resnet18-imagenet"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="resnet",
        resnet_blocks=(2, 2, 2, 2),
        resnet_width=64,
        num_classes=1000,
        image_size=224,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="resnet",
        resnet_blocks=(1, 1),
        resnet_width=8,
        num_classes=10,
        image_size=32,
    )


register_arch(NAME, full, smoke)
