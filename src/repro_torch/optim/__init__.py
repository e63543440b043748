from repro_torch.optim.optimizers import (Optimizer, ServerOptimizer, adamw,
                                          apply_updates, fedadam, fedavgm,
                                          fedyogi, sgd)

__all__ = ["Optimizer", "ServerOptimizer", "adamw", "apply_updates",
           "fedadam", "fedavgm", "fedyogi", "sgd"]
