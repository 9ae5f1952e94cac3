"""ResNet: the port of ``models/resnet.py`` (ResNet-18/34/50/101/152).

Bottleneck-v1.5 (the stride in the 3×3 conv) or the basic two-3×3 block;
the ImageNet stem (7×7/s2 conv + 3×3/s2 SAME max-pool), the CIFAR stem
(one 3×3/s1 conv) or the space-to-depth stem (s2d 2×2 → 4×4/s1 conv
padded ((1,2),(1,2)) → max-pool, the same function class as the 7×7 stem
with 12,288 stem weights instead of 9,408); the zero-init gamma on the
last BN of every block; a projection ConvBN where the block changes the
shape; the global mean in the compute dtype, then an f32 classifier. The
module names follow the Flax tree (``stem``, ``stem_s2d``,
``stage{s}_block{b}/conv{1,2,3}``, ``proj``, ``classifier``) and
ResNet-50 has 25,557,032 parameters at 1000 classes.

Parameters and BN statistics are f32; convolutions run in ``dtype``
(bf16 in the configs). The NHWC input is permuted once at entry; on the
card the body runs channels_last (models/layers.py).

``matmul_dtype="int8"`` (``precision.matmul_dtype``) runs every ConvBN's
contraction on the int8 block codec (models/layers.py ``QuantConv``);
the classifier is never quantized.

``remat`` checkpoints each residual block (models/remat.py): with
``remat_policy`` "full" the backward replays the whole block, with
"conv_saved" it keeps each ConvBN's convolution output and replays only
the BatchNorm, ReLU and residual tail; ``ckpt_policy``
(``precision.remat_policy``: "save_nothing" or "dots_saveable") wins
over ``remat_policy`` when set. The replay leaves the BatchNorm running
statistics alone, so a step's parameters and statistics are those
without remat.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_framework_torch.models import remat as remat_lib
from distributed_tensorflow_framework_torch.models.layers import (
    ConvBN,
    Dense,
    max_pool_same,
    nhwc_to_nchw,
    space_to_depth,
)


REMAT_POLICIES = ("full", "conv_saved")


def _remat_policy_error(got: str) -> str:
    return f"remat_policy must be one of {REMAT_POLICIES}, got {got!r}"


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 (4× wide, zero-init gamma), plus the
    residual. The JAX block projects when the residual's shape differs
    from the output's; for every input of at least 2×2 that is when the
    stride is not 1 or the width changes, which is decided here at
    construction."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides=(1, 1), *,
                 dtype: torch.dtype, matmul_dtype: str = "", device=None):
        super().__init__()
        out = self.expansion * features
        kw = dict(dtype=dtype, matmul_dtype=matmul_dtype, device=device)
        self.conv1 = ConvBN(in_features, features, (1, 1), **kw)
        self.conv2 = ConvBN(features, features, (3, 3), strides=strides,
                            **kw)
        self.conv3 = ConvBN(features, out, (1, 1), use_relu=False,
                            zero_init_gamma=True, **kw)
        self.proj = (ConvBN(in_features, out, (1, 1), strides=strides,
                            use_relu=False, **kw)
                     if tuple(strides) != (1, 1) or in_features != out
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.proj is None else self.proj(x)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """Two 3×3 ConvBNs (the second with zero-init gamma) plus the
    residual: the ResNet-18/34 unit."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides=(1, 1), *,
                 dtype: torch.dtype, matmul_dtype: str = "", device=None):
        super().__init__()
        kw = dict(dtype=dtype, matmul_dtype=matmul_dtype, device=device)
        self.conv1 = ConvBN(in_features, features, (3, 3), strides=strides,
                            **kw)
        self.conv2 = ConvBN(features, features, (3, 3), use_relu=False,
                            zero_init_gamma=True, **kw)
        self.proj = (ConvBN(in_features, features, (1, 1), strides=strides,
                            use_relu=False, **kw)
                     if tuple(strides) != (1, 1) or in_features != features
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        residual = x if self.proj is None else self.proj(x)
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 *, width: int = 64, cifar_stem: bool = False,
                 basic_block: bool = False,
                 space_to_depth_stem: bool = False, in_channels: int = 3,
                 remat: bool = False, remat_policy: str = "full",
                 ckpt_policy: str | None = None, matmul_dtype: str = "",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if cifar_stem and space_to_depth_stem:
            raise ValueError("space_to_depth_stem only applies to the "
                             "ImageNet stem (cifar_stem=False)")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(_remat_policy_error(remat_policy))
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        self.space_to_depth_stem = space_to_depth_stem
        self.remat = remat
        # The block checkpoint's save policy (models/remat.py): the
        # precision one wins, "full" keeps nothing.
        self.block_policy = (ckpt_policy if ckpt_policy is not None
                             else "conv_saved" if remat_policy == "conv_saved"
                             else None)
        kw = dict(dtype=dtype, matmul_dtype=matmul_dtype, device=device)
        if cifar_stem:
            self.stem = ConvBN(in_channels, width, (3, 3), **kw)
        elif space_to_depth_stem:
            # ((1,2),(1,2)) on the half-res grid is the 7×7/s2 SAME
            # padding (2 before, 3 after) at full res.
            self.stem_s2d = ConvBN(4 * in_channels, width, (4, 4),
                                   padding=((1, 2), (1, 2)), **kw)
        else:
            self.stem = ConvBN(in_channels, width, (7, 7), strides=(2, 2),
                               **kw)
        block_cls = BasicBlock if basic_block else Bottleneck
        features = width
        self.block_names = []
        for stage, size in enumerate(stage_sizes):
            for block in range(size):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                name = f"stage{stage + 1}_block{block + 1}"
                self.add_module(name, block_cls(
                    features, width * 2 ** stage, strides, **kw))
                self.block_names.append(name)
                features = block_cls.expansion * width * 2 ** stage
        self.classifier = Dense(features, num_classes, dtype=torch.float32,
                                device=device)

    def init_weights(self, generator: torch.Generator | None) -> None:
        for module in self.modules():
            if isinstance(module, ConvBN):
                module.reset_parameters(generator)
        self.classifier.reset_parameters(generator)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = image.to(self.dtype)
        if self.space_to_depth_stem:
            x = space_to_depth(x, 2)
        x = nhwc_to_nchw(x)
        if self.cifar_stem:
            x = self.stem(x)
        elif self.space_to_depth_stem:
            x = max_pool_same(self.stem_s2d(x), 3, 2)
        else:
            x = max_pool_same(self.stem(x), 3, 2)
        remat = self.remat and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = (remat_lib.checkpoint(block, x, policy=self.block_policy)
                 if remat else block(x))
        x = x.mean(dim=(2, 3))
        return self.classifier(x.float())


# Canonical depth → (stage sizes, basic block).
RESNET_DEPTHS: dict[int, tuple[tuple[int, ...], bool]] = {
    18: ((2, 2, 2, 2), True),
    34: ((3, 4, 6, 3), True),
    50: ((3, 4, 6, 3), False),
    101: ((3, 4, 23, 3), False),
    152: ((3, 8, 36, 3), False),
}


def make_resnet(depth: int, num_classes: int = 1000, *,
                dtype: torch.dtype = torch.bfloat16,
                cifar_stem: bool = False, space_to_depth_stem: bool = False,
                in_channels: int = 3, remat: bool = False,
                remat_policy: str = "full", ckpt_policy: str | None = None,
                matmul_dtype: str = "", device=None) -> ResNet:
    if depth not in RESNET_DEPTHS:
        raise ValueError(
            f"resnet depth {depth} not in {sorted(RESNET_DEPTHS)}")
    stages, basic = RESNET_DEPTHS[depth]
    return ResNet(stages, num_classes, basic_block=basic,
                  cifar_stem=cifar_stem,
                  space_to_depth_stem=space_to_depth_stem,
                  in_channels=in_channels, remat=remat,
                  remat_policy=remat_policy, ckpt_policy=ckpt_policy,
                  matmul_dtype=matmul_dtype, dtype=dtype, device=device)
