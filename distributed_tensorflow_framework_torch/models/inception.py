"""Inception-v3: the port of ``models/inception.py``.

The canonical topology at 299 x 299: a stem of 3 x 3 ConvBNs and two
VALID max-pools, 3 x InceptionA (35 x 35), ReductionA, 4 x InceptionB
(17 x 17), ReductionB, 2 x InceptionC (8 x 8), the global mean, dropout
0.2 and an f32 classifier; the auxiliary classifier hangs off the last
17 x 17 block. Every branch is a ConvBN (``_C``, whose Flax name is
``convbn``), so the modules follow the Flax tree (``stem1``...``stem5``,
``mixed1``...``mixed9``, ``reduce1``/``reduce2``, ``aux_proj``,
``aux_conv``, ``aux_classifier``, ``classifier``) and
models/convert.py maps them by name. 27,161,264 parameters at 1000
classes with the aux head (23,834,568 without it), the JAX model's count.

As in the JAX model:
  * the branch pools are Flax ``avg_pool`` SAME, which counts the padding
    (``count_include_pad``): a border window divides by 9;
  * the 1 x 7 and 7 x 1 convolutions take XLA's SAME pads per axis;
  * the aux head pools 5 x 5 / 3 and convolves 5 x 5 VALID when the map is
    at least 5 x 5 (at 299 the 17 x 17 map gives 5 x 5, then 1 x 1) and
    SAME otherwise, decided at run time from the shape;
  * the aux head is always built; in train mode the forward returns
    ``{"logits", "aux_logits"}`` (the step weights the aux loss 0.4), in
    eval mode the logits alone, and the aux head does not run;
  * dropout (train mode, before the classifier) draws from the
    ``dropout_generator`` the caller passes (the trainer's per-step
    stream), never from the global RNG.

Parameters and BN statistics are f32; convolutions run in ``dtype``. The
NHWC input is permuted once at entry; on the card the body runs
channels_last. ``remat`` checkpoints each mixed and reduction block
(models/remat.py), with ``ckpt_policy`` (``precision.remat_policy``)
selecting what the checkpoint keeps; the replay leaves the BatchNorm
running statistics alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_framework_torch.models import remat as remat_lib
from distributed_tensorflow_framework_torch.models.layers import (
    ConvBN,
    Dense,
    dropout,
    nhwc_to_nchw,
    pad_nchw,
    same_pads,
)


class _C(nn.Module):
    """A ConvBN under the Flax name ``convbn`` (the JAX ``_C``)."""

    def __init__(self, in_features: int, features: int, kernel, strides=(1, 1),
                 padding="SAME", *, dtype: torch.dtype, device=None):
        super().__init__()
        self.convbn = ConvBN(in_features, features, tuple(kernel),
                             strides=strides, padding=padding, dtype=dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convbn(x)


def avg_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Flax ``nn.avg_pool(padding="SAME")``: XLA's SAME pads of zeros, each
    window's sum over window² (the padding counts)."""
    pads = (same_pads(x.shape[2], window, stride),
            same_pads(x.shape[3], window, stride))
    return F.avg_pool2d(pad_nchw(x, pads), window, stride)


class InceptionA(nn.Module):
    def __init__(self, in_features: int, pool_features: int, **kw):
        super().__init__()
        self.b1x1 = _C(in_features, 64, (1, 1), **kw)
        self.b5x5_1 = _C(in_features, 48, (1, 1), **kw)
        self.b5x5_2 = _C(48, 64, (5, 5), **kw)
        self.b3x3dbl_1 = _C(in_features, 64, (1, 1), **kw)
        self.b3x3dbl_2 = _C(64, 96, (3, 3), **kw)
        self.b3x3dbl_3 = _C(96, 96, (3, 3), **kw)
        self.bpool = _C(in_features, pool_features, (1, 1), **kw)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.b1x1(x), self.b5x5_2(self.b5x5_1(x)),
            self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x))),
            self.bpool(avg_pool_same(x, 3, 1))], dim=1)


class ReductionA(nn.Module):
    def __init__(self, in_features: int, **kw):
        super().__init__()
        self.b3x3 = _C(in_features, 384, (3, 3), (2, 2), "VALID", **kw)
        self.b3x3dbl_1 = _C(in_features, 64, (1, 1), **kw)
        self.b3x3dbl_2 = _C(64, 96, (3, 3), **kw)
        self.b3x3dbl_3 = _C(96, 96, (3, 3), (2, 2), "VALID", **kw)
        self.out_features = 384 + 96 + in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.b3x3(x), self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x))),
            F.max_pool2d(x, 3, 2)], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_features: int, channels_7x7: int, **kw):
        super().__init__()
        c = channels_7x7
        self.b1x1 = _C(in_features, 192, (1, 1), **kw)
        self.b7x7_1 = _C(in_features, c, (1, 1), **kw)
        self.b7x7_2 = _C(c, c, (1, 7), **kw)
        self.b7x7_3 = _C(c, 192, (7, 1), **kw)
        self.b7x7dbl_1 = _C(in_features, c, (1, 1), **kw)
        self.b7x7dbl_2 = _C(c, c, (7, 1), **kw)
        self.b7x7dbl_3 = _C(c, c, (1, 7), **kw)
        self.b7x7dbl_4 = _C(c, c, (7, 1), **kw)
        self.b7x7dbl_5 = _C(c, 192, (1, 7), **kw)
        self.bpool = _C(in_features, 192, (1, 1), **kw)
        self.out_features = 4 * 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        b3 = self.b7x7dbl_1(x)
        for conv in (self.b7x7dbl_2, self.b7x7dbl_3, self.b7x7dbl_4,
                     self.b7x7dbl_5):
            b3 = conv(b3)
        return torch.cat([self.b1x1(x), b2, b3,
                          self.bpool(avg_pool_same(x, 3, 1))], dim=1)


class ReductionB(nn.Module):
    def __init__(self, in_features: int, **kw):
        super().__init__()
        self.b3x3_1 = _C(in_features, 192, (1, 1), **kw)
        self.b3x3_2 = _C(192, 320, (3, 3), (2, 2), "VALID", **kw)
        self.b7x7x3_1 = _C(in_features, 192, (1, 1), **kw)
        self.b7x7x3_2 = _C(192, 192, (1, 7), **kw)
        self.b7x7x3_3 = _C(192, 192, (7, 1), **kw)
        self.b7x7x3_4 = _C(192, 192, (3, 3), (2, 2), "VALID", **kw)
        self.out_features = 320 + 192 + in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.b7x7x3_1(x)
        for conv in (self.b7x7x3_2, self.b7x7x3_3, self.b7x7x3_4):
            b2 = conv(b2)
        return torch.cat([self.b3x3_2(self.b3x3_1(x)), b2,
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_features: int, **kw):
        super().__init__()
        self.b1x1 = _C(in_features, 320, (1, 1), **kw)
        self.b3x3_1 = _C(in_features, 384, (1, 1), **kw)
        self.b3x3_2a = _C(384, 384, (1, 3), **kw)
        self.b3x3_2b = _C(384, 384, (3, 1), **kw)
        self.b3x3dbl_1 = _C(in_features, 448, (1, 1), **kw)
        self.b3x3dbl_2 = _C(448, 384, (3, 3), **kw)
        self.b3x3dbl_3a = _C(384, 384, (1, 3), **kw)
        self.b3x3dbl_3b = _C(384, 384, (3, 1), **kw)
        self.bpool = _C(in_features, 192, (1, 1), **kw)
        self.out_features = 320 + 4 * 384 + 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.b3x3_1(x)
        b3 = self.b3x3dbl_2(self.b3x3dbl_1(x))
        return torch.cat([
            self.b1x1(x), self.b3x3_2a(b2), self.b3x3_2b(b2),
            self.b3x3dbl_3a(b3), self.b3x3dbl_3b(b3),
            self.bpool(avg_pool_same(x, 3, 1))], dim=1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000, *, dropout_rate: float = 0.2,
                 in_channels: int = 3, remat: bool = False,
                 ckpt_policy: str | None = None,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.ckpt_policy = ckpt_policy
        self.dropout_rate = dropout_rate
        kw = dict(dtype=dtype, device=device)
        self.stem1 = _C(in_channels, 32, (3, 3), (2, 2), "VALID", **kw)
        self.stem2 = _C(32, 32, (3, 3), padding="VALID", **kw)
        self.stem3 = _C(32, 64, (3, 3), **kw)
        self.stem4 = _C(64, 80, (1, 1), padding="VALID", **kw)
        self.stem5 = _C(80, 192, (3, 3), padding="VALID", **kw)
        blocks = [("mixed1", InceptionA, (32,)), ("mixed2", InceptionA, (64,)),
                  ("mixed3", InceptionA, (64,)), ("reduce1", ReductionA, ()),
                  ("mixed4", InceptionB, (128,)),
                  ("mixed5", InceptionB, (160,)),
                  ("mixed6", InceptionB, (160,)),
                  ("mixed7", InceptionB, (192,)), ("reduce2", ReductionB, ()),
                  ("mixed8", InceptionC, ()), ("mixed9", InceptionC, ())]
        features = 192
        for name, cls, args in blocks:
            block = cls(features, *args, **kw)
            self.add_module(name, block)
            features = block.out_features
            if name == "mixed7":
                aux_features = features
        self.aux_proj = _C(aux_features, 128, (1, 1), **kw)
        self.aux_conv = _C(128, 768, (5, 5), **kw)
        self.aux_classifier = Dense(768, num_classes, dtype=torch.float32,
                                    device=device)
        self.classifier = Dense(features, num_classes, dtype=torch.float32,
                                device=device)
        self.block_names = [name for name, _, _ in blocks]

    def init_weights(self, generator: torch.Generator | None) -> None:
        for module in self.modules():
            if isinstance(module, ConvBN):
                module.reset_parameters(generator)
        self.aux_classifier.reset_parameters(generator)
        self.classifier.reset_parameters(generator)

    def _aux(self, x: torch.Tensor) -> torch.Tensor:
        """The aux head on the last 17 x 17 map: pool and conv VALID on a
        map of at least 5 x 5, SAME on a smaller one."""
        valid = x.shape[2] >= 5 and x.shape[3] >= 5
        a = F.avg_pool2d(x, 5, 3) if valid else avg_pool_same(x, 5, 3)
        a = self.aux_proj(a)
        convbn = self.aux_conv.convbn
        padding = "VALID" if a.shape[2] >= 5 and a.shape[3] >= 5 else "SAME"
        a = F.relu(convbn.bn(convbn.conv(a, padding))).mean(dim=(2, 3))
        return self.aux_classifier(a.float())

    def forward(self, image: torch.Tensor,
                dropout_generator: torch.Generator | None = None):
        x = nhwc_to_nchw(image.to(self.dtype))
        for stem in (self.stem1, self.stem2, self.stem3):
            x = stem(x)
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.stem5(self.stem4(x)), 3, 2)
        aux = None
        remat = self.remat and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = (remat_lib.checkpoint(block, x, policy=self.ckpt_policy)
                 if remat else block(x))
            if name == "mixed7" and self.training:
                aux = self._aux(x)
        x = dropout(x.mean(dim=(2, 3)), self.dropout_rate, dropout_generator,
                    self.training)
        logits = self.classifier(x.float())
        if aux is not None:
            return {"logits": logits, "aux_logits": aux}
        return logits
