"""LeNet-5: the port of ``models/lenet.py``, the MNIST smoke-test model.

conv(6, 5×5 SAME) → ReLU → avg-pool 2 → conv(16, 5×5 VALID) → ReLU →
avg-pool 2 → dense(120) → ReLU → dense(84) → ReLU → dense(classes), with
the Flax module names (``conv1``, ``conv2``, ``fc1``, ``fc2``, ``logits``)
and 61,706 parameters at 10 classes. The convolutions keep Flax
``nn.Conv``'s default init (variance_scaling(1, fan_in, truncated)) and a
bias; the dense layers use the JAX ``dense_kernel_init``.

The input is the NHWC batch; the body runs NCHW (models/layers.py). Before
``fc1`` the activations go back to NHWC and are flattened in (h, w, c)
order, as the JAX model flattens them, so ``fc1``'s 400 inputs are in the
Flax kernel's row order and models/convert.py carries it unchanged.

``matmul_dtype="int8"`` (``precision.matmul_dtype``) runs ``fc1`` and
``fc2`` as :class:`~.layers.QuantDense` under the same parameters; the
``logits`` layer stays f32, as in the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_framework_torch.models.layers import (
    Conv,
    Dense,
    QuantDense,
    nhwc_to_nchw,
)


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, *, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, matmul_dtype: str = "",
                 device=None):
        super().__init__()
        self.dtype = dtype
        body = QuantDense if matmul_dtype == "int8" else Dense
        self.conv1 = Conv(in_channels, 6, (5, 5), padding="SAME",
                          use_bias=True, dtype=dtype, device=device)
        self.conv2 = Conv(6, 16, (5, 5), padding="VALID", use_bias=True,
                          dtype=dtype, device=device)
        self.fc1 = body(400, 120, dtype=dtype, device=device)
        self.fc2 = body(120, 84, dtype=dtype, device=device)
        self.logits = Dense(84, num_classes, dtype=torch.float32,
                            device=device)

    def init_weights(self, generator: torch.Generator | None) -> None:
        self.conv1.reset_parameters(generator, init="lecun")
        self.conv2.reset_parameters(generator, init="lecun")
        for dense in (self.fc1, self.fc2, self.logits):
            dense.reset_parameters(generator)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(image.to(self.dtype))
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        return self.logits(x)
