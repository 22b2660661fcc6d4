from repro_torch.optim.optimizers import adagrad, adam, sgd  # noqa: F401
