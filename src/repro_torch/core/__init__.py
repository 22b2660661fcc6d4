"""Copy of ``repro.core``; the port imports nothing of ``repro``."""

from repro_torch.core.costs import CostModel, SystemCost
from repro_torch.core.preferences import Preference
from repro_torch.core.fedtune import FedTune, FedTuneConfig
from repro_torch.core.tuner import FixedTuner, Tuner

__all__ = ["CostModel", "SystemCost", "Preference", "FedTune",
           "FedTuneConfig", "FixedTuner", "Tuner"]
