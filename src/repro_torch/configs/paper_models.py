"""The paper's own measurement-study models (Table 2 + §5.1).

ResNet-10/18/26/34 for 32x32 single-channel spectrograms (speech-to-command),
ResNet-10/18 for CIFAR-100-like, and the 2-layer MLP for EMNIST.  These are
vision models, configured by a separate lightweight dataclass (the LM
``ModelConfig`` does not apply).

Copy of ``repro.configs.paper_models``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ResNetConfig:
    name: str
    stage_blocks: Tuple[int, int, int, int]   # BasicBlocks per stage
    width: int                                # first-stage channels
    n_classes: int
    in_channels: int = 1
    image_size: int = 32
    source: str = "arXiv:1512.03385 (He et al.); Table 2 of FedTune"


@dataclass(frozen=True)
class MLPConfig:
    name: str
    in_dim: int
    hidden: Tuple[int, ...]
    n_classes: int
    source: str = "FedTune §5.1 (EMNIST MLP, one hidden layer of 200 ReLU)"


def resnet(name: str, blocks, n_classes=35, in_channels=1, width=8) -> ResNetConfig:
    # width=8 reproduces the paper's Table 2 parameter counts
    # (ResNet-10 ~79.7K, ResNet-18 ~177.2K).
    return ResNetConfig(name=name, stage_blocks=tuple(blocks), width=width,
                        n_classes=n_classes, in_channels=in_channels)


# Table 2 of the paper: BasicBlock counts per stage.
RESNET10 = resnet("resnet10", (1, 1, 1, 1))
RESNET18 = resnet("resnet18", (2, 2, 2, 2))
RESNET26 = resnet("resnet26", (3, 3, 3, 3))
RESNET34 = resnet("resnet34", (3, 4, 6, 3))

MLP_EMNIST = MLPConfig(name="mlp_emnist", in_dim=28 * 28, hidden=(200,), n_classes=62)

PAPER_MODELS = {
    m.name: m for m in (RESNET10, RESNET18, RESNET26, RESNET34, MLP_EMNIST)
}
