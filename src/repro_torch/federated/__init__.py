from repro_torch.federated.aggregation import get_aggregator
from repro_torch.federated.client import local_train
from repro_torch.federated.evaluation import Evaluator
from repro_torch.federated.server import FLConfig, FLServer

__all__ = ["get_aggregator", "local_train", "FLConfig", "FLServer",
           "Evaluator"]
