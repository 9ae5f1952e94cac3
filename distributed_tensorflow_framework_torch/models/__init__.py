"""Model registry: ``get_model`` from a ModelConfig.

Port of ``models/__init__.py``'s name dispatch: ``bert`` (BERT-base MLM),
``lenet``/``lenet5``/``lenet-5``, ``resnet-?N(_cifar|-cifar)?``
(ResNet-18 to 152; the ``_cifar`` suffix takes the CIFAR stem) and
``inception_v3``. The JAX package's validation errors on
``space_to_depth_stem``, ``remat`` and ``remat_policy`` are kept. Every
configuration the port cannot build yet raises NotImplementedError naming
the ROADMAP.md item that ports it (MoE and pipelined BERT, ResNet and
Inception remat); ``register_model`` is item A19. Ring attention builds
here and runs under ``train.spmd_mode: jit`` only
(:func:`check_ring_mode`).
"""

from __future__ import annotations

import re

import torch
from torch import nn

from distributed_tensorflow_framework_torch.core.config import ModelConfig
from distributed_tensorflow_framework_torch.core.device import resolve_device

BERT_NAMES = ("bert", "bert_base", "bert-base")
LENET_NAMES = ("lenet", "lenet5", "lenet-5")
INCEPTION_NAMES = ("inception_v3", "inception-v3", "inceptionv3")
_RESNET = re.compile(r"resnet-?(\d+)(_cifar|-cifar)?")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet — ROADMAP.md queue A item {item}")


def _check_common(config: ModelConfig, name: str) -> None:
    """The JAX package's cross-model validation (``get_model``)."""
    is_resnet = _RESNET.fullmatch(name) is not None
    if config.remat and not (name in BERT_NAMES or is_resnet
                             or name in INCEPTION_NAMES):
        raise ValueError(
            f"model.remat is only supported for the transformer (bert), "
            f"resnet and inception models, not {config.name!r}")
    if config.remat_policy != "full" and not (config.remat and is_resnet):
        raise ValueError(
            f"model.remat_policy={config.remat_policy!r} requires "
            f"model.remat=true on a resnet model (the conv_saved policy "
            f"keys on the ConvBN conv_out tag)")
    if config.space_to_depth_stem and not is_resnet:
        raise ValueError(
            f"model.space_to_depth_stem is a ResNet ImageNet-stem "
            f"optimization, not supported for {config.name!r}")
    if config.dtype not in _DTYPES:
        raise ValueError(f"model.dtype {config.dtype!r} not in "
                         f"{sorted(_DTYPES)}")


def model_kwargs(config: ModelConfig) -> dict:
    """BertForMLM constructor arguments for ``config``; raises for what the
    port does not support yet."""
    if config.name.lower() not in BERT_NAMES:
        raise ValueError(f"{config.name!r} is not a BERT model")
    _check_common(config, config.name.lower())
    if config.num_experts > 0:
        raise _not_ported("MoE encoder layers (model.num_experts>0)", "A8")
    if config.pipeline_stages > 1:
        raise _not_ported("pipelined BERT (model.pipeline_stages>1)", "A12")
    return dict(
        vocab_size=config.vocab_size, hidden_size=config.hidden_size,
        num_layers=config.num_layers, num_heads=config.num_heads,
        mlp_dim=config.mlp_dim, max_seq_len=config.max_seq_len,
        dropout_rate=config.dropout_rate, dtype=_DTYPES[config.dtype],
        attention_impl=config.attention_impl, fused_qkv=config.fused_qkv,
        remat=config.remat)


def check_ring_mode(config: ModelConfig, spmd_mode: str) -> None:
    """Refuse ring attention under ``train.spmd_mode: shard_map``: the JAX
    package fails there (its ``ring_attention_sharded`` nests a
    ``shard_map`` inside the step's own ``shard_map``), so the port raises
    the same cause as a ValueError."""
    if (spmd_mode == "shard_map" and config.attention_impl == "ring"
            and config.name.lower() in BERT_NAMES):
        raise ValueError(
            "model.attention_impl='ring' runs under train.spmd_mode='jit' "
            "only: under 'shard_map' the JAX package's ring_attention_sharded "
            "nests a shard_map inside the step's own shard_map and fails "
            "with \"ValueError: The context mesh AbstractMesh(...Manual...) "
            "should match the mesh passed to shard_map Mesh(...Auto...)\"")


def build_model(config: ModelConfig, *, device: torch.device,
                in_channels: int | None = None) -> nn.Module:
    """The uninitialised module for ``config`` on ``device``.
    ``in_channels`` (the data's ``channels``) defaults to 1 for LeNet and
    3 for ResNet and Inception."""
    name = config.name.lower()
    if name in BERT_NAMES:
        from distributed_tensorflow_framework_torch.models.bert import (
            BertForMLM,
        )

        return BertForMLM(**model_kwargs(config), device=device)
    _check_common(config, name)
    dtype = _DTYPES[config.dtype]
    if name in LENET_NAMES:
        from distributed_tensorflow_framework_torch.models.lenet import LeNet5

        return LeNet5(config.num_classes, in_channels=in_channels or 1,
                      dtype=dtype, device=device)
    m = _RESNET.fullmatch(name)
    if m:
        if config.remat:
            raise _not_ported(
                "model.remat on a ResNet (torch.utils.checkpoint replays "
                "each BN's running-statistics update)", "A18")
        from distributed_tensorflow_framework_torch.models.resnet import (
            make_resnet,
        )

        return make_resnet(int(m.group(1)), config.num_classes, dtype=dtype,
                           cifar_stem=m.group(2) is not None,
                           space_to_depth_stem=config.space_to_depth_stem,
                           in_channels=in_channels or 3, device=device)
    if name in INCEPTION_NAMES:
        if config.remat:
            raise _not_ported(
                "model.remat on Inception-v3 (torch.utils.checkpoint replays "
                "each BN's running-statistics update)", "A18")
        from distributed_tensorflow_framework_torch.models.inception import (
            InceptionV3,
        )

        return InceptionV3(config.num_classes, in_channels=in_channels or 3,
                           dtype=dtype, device=device)
    raise ValueError(f"Unknown model {config.name!r}")


def get_model(config: ModelConfig, *, device: str | torch.device = "cuda",
              generator: torch.Generator | None = None,
              in_channels: int | None = None) -> nn.Module:
    """Build the model on ``device`` (default CUDA; raises when CUDA is
    absent unless ``device="cpu"``) with its parameters drawn from
    ``generator`` (default: seed 0 on that device). Eval mode: the
    trainer switches it to ``train()``. Image models on a CUDA device are
    laid out channels_last."""
    dev = resolve_device(device)
    model = build_model(config, device=dev, in_channels=in_channels)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model.init_weights(generator)
    if dev.type == "cuda" and config.name.lower() not in BERT_NAMES:
        model = model.to(memory_format=torch.channels_last)
    return model.eval()
