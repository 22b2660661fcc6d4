"""Copy of ``repro.data``; the port imports nothing of ``repro``."""

from repro_torch.data.synthetic import (FederatedDataset, make_dataset,
                                  speech_command_like, emnist_like,
                                  cifar100_like)
from repro_torch.data.loader import client_batches

__all__ = ["FederatedDataset", "make_dataset", "speech_command_like",
           "emnist_like", "cifar100_like", "client_batches"]
