"""Training on one device: the optimizer, the train step, checkpoints and
fault tolerance (the JAX package's ``repro.training``)."""
from repro_torch.training import (checkpoint, fault_tolerance, optimizer,
                                  train_loop)

__all__ = ["checkpoint", "fault_tolerance", "optimizer", "train_loop"]
