"""Training state: the port's counterpart of ``train/state.py``'s
``TrainState``.

The step counter, the parameters (the model), the optimizer and its
state, and the dropout generator (the JAX state's ``rng``). PyTorch
updates the parameters and optimizer slots in place, so the state is a
mutable record rather than a pytree that each step replaces.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from distributed_tensorflow_framework_torch.models.bert import BertForMLM
from distributed_tensorflow_framework_torch.train.optimizers import AdamW


@dataclass
class TrainState:
    step: int
    model: BertForMLM
    optimizer: AdamW
    dropout_generator: torch.Generator
