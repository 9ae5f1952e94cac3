"""Model registry: ``get_model`` from a ModelConfig.

Port of ``models/__init__.py``'s name dispatch: ``bert`` (BERT-base MLM),
``lenet``/``lenet5``/``lenet-5``, ``resnet-?N(_cifar|-cifar)?``
(ResNet-18 to 152; the ``_cifar`` suffix takes the CIFAR stem) and
``inception_v3``. The JAX package's validation errors on
``space_to_depth_stem``, ``remat`` and ``remat_policy`` are kept.
``model.remat`` checkpoints BERT's encoder layers, ResNet's residual
blocks (``model.remat_policy`` full or conv_saved) and Inception-v3's
mixed and reduction blocks (models/remat.py).

``precision`` (the config's ``PrecisionConfig``; the trainer passes it,
serving does not, as in the JAX package) threads the precision pack into
the builders: ``activation_dtype`` (f32 or bf16) overrides
``model.dtype`` for the compute casts, the parameters staying f32;
``matmul_dtype: int8`` runs LeNet's dense body and every ResNet ConvBN on
the int8 block codec (models/layers.py); ``remat_policy``
(save_nothing or dots_saveable) is the save policy of the per-block
checkpoint, and of the pipeline stages' per-layer one. The JAX package's
refusals are kept with its exception types and messages
(:func:`check_precision`).

``register_model`` is the extension point (JAX ``models/__init__.py``): a
user builder registered under a name that no built-in pattern holds
(:func:`_is_builtin_model_name`) is what ``get_model`` builds for that
``model.name``, with its task (:func:`custom_model_task`) picking the
loss and the batch wiring; the precision pack is refused on it, as the
JAX package refuses it. :func:`decode_support_reason` says why a config
cannot take the autoregressive decode path (serve/decode.py).

Ring attention builds here and runs under ``train.spmd_mode: jit`` only
(:func:`check_ring_mode`). With ``model.pipeline_stages > 1`` BERT is
built whole from the seed and parallel/pipeline.py's ``PipelinedBert``
keeps this rank's stage of it, which needs the mesh runtime; the JAX
package's refusals beside the pipeline are kept with its exception types
(MoE; ``model.remat``; ring attention). BERT with ``model.num_experts >
0`` takes MoE FFN layers (models/moe.py).
"""

from __future__ import annotations

import re
from typing import Callable

import torch
from torch import nn

from distributed_tensorflow_framework_torch.core.config import ModelConfig
from distributed_tensorflow_framework_torch.core.device import resolve_device

BERT_NAMES = ("bert", "bert_base", "bert-base")
LENET_NAMES = ("lenet", "lenet5", "lenet-5")
INCEPTION_NAMES = ("inception_v3", "inception-v3", "inceptionv3")
_RESNET = re.compile(r"resnet-?(\d+)(_cifar|-cifar)?")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


_ACTIVATION_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# name → (builder(config, device=..., generator=...) -> module, task).
_CUSTOM_MODELS: dict[str, tuple[Callable[..., nn.Module], str]] = {}


def _is_builtin_model_name(name: str) -> bool:
    """Name-pattern twin of :func:`build_model`'s dispatch — keep the two
    in sync when adding a model family. The whole resnet-N pattern is
    reserved (including depths that don't exist yet)."""
    return (name in (*LENET_NAMES, *BERT_NAMES, *INCEPTION_NAMES)
            or _RESNET.fullmatch(name) is not None)


def register_model(name: str, *, task: str = "classification"):
    """Register a user model builder under ``model.name`` (decorator).

    The builder receives the full ModelConfig plus the keywords the
    built-ins get (``device``, and ``generator``, the stream its
    parameters are drawn from) and returns an initialised ``nn.Module``.
    Its ``forward`` takes a ``train`` keyword, which ``get_model`` fills
    with the module's ``training`` flag (the trainer switches it to
    ``train()``), and its positional inputs match ``task``:
    "classification" (NHWC images → logits) or "mlm" ((ids, mask[,
    segment_ids]) → logits) — the task picks the loss and batch wiring
    (train/step.py). The builder owns the interpretation of every other
    ModelConfig knob. Built-in names cannot be shadowed, and duplicate
    registrations fail loudly.

        @register_model("my_net")
        def build(config, *, device=None, generator=None):
            return MyNet(config.num_classes, device=device,
                         generator=generator)
    """
    key = name.lower()
    if task not in ("classification", "mlm"):
        raise ValueError(f"unknown task {task!r} for model {name!r}")

    def deco(builder):
        if key in _CUSTOM_MODELS:
            raise ValueError(f"model {name!r} already registered")
        if _is_builtin_model_name(key):
            raise ValueError(f"model {name!r} shadows a built-in")
        _CUSTOM_MODELS[key] = (builder, task)
        return builder

    return deco


def decode_support_reason(model_config) -> str | None:
    """Why ``model_config`` cannot take the autoregressive decode path
    (None = supported) — models/bert.py's reason, and a registered model
    refused by name."""
    from distributed_tensorflow_framework_torch.models import bert

    if model_config.name.lower() in _CUSTOM_MODELS:
        return (f"custom model {model_config.name!r} has no causal decode "
                f"head (decode supports the dense bert family)")
    return bert.decode_support_reason(model_config)


def custom_model_task(name: str) -> str | None:
    """Task family of a registered custom model, or None if not custom."""
    entry = _CUSTOM_MODELS.get(name.lower())
    return entry[1] if entry else None


def _pass_train(module: nn.Module, args: tuple, kwargs: dict):
    """Forward pre-hook of a registered model: ``train=`` from the
    module's mode unless the caller passed it."""
    return args, {"train": module.training, **kwargs}


def _build_custom(config: ModelConfig, device: torch.device,
                  generator: torch.Generator, precision) -> nn.Module:
    check_precision(config, precision)
    model = _CUSTOM_MODELS[config.name.lower()][0](
        config, device=device, generator=generator)
    model.register_forward_pre_hook(_pass_train, with_kwargs=True)
    return model


def check_precision(config: ModelConfig, precision=None) -> None:
    """The JAX ``get_model``'s refusals of the precision pack, in its
    order: any of it on a registered model, a ``precision.remat_policy``
    beside ``model.remat_policy != full`` or without ``model.remat``
    (pipeline stages exempt), and ``precision.matmul_dtype`` on a model
    other than LeNet and ResNet."""
    if precision is None:
        return
    name = config.name.lower()
    if name in _CUSTOM_MODELS:
        if (precision.matmul_dtype or precision.activation_dtype
                or precision.remat_policy != "none"):
            raise ValueError(
                f"precision.activation_dtype/matmul_dtype/remat_policy are "
                f"not threaded through custom model {config.name!r} — the "
                f"registered builder owns its ModelConfig interpretation")
        return
    if precision.remat_policy != "none":
        if config.remat_policy != "full":
            raise ValueError(
                "precision.remat_policy conflicts with "
                f"model.remat_policy={config.remat_policy!r} — pick one "
                "spelling (the precision block is the cross-model one)")
        if not config.remat and config.pipeline_stages <= 1:
            raise ValueError(
                "precision.remat_policy requires model.remat=true (the "
                "policy selects WHAT the per-block checkpoint saves; "
                "pipeline stages checkpoint their own layer applies and "
                "are exempt)")
    if precision.matmul_dtype and not (
            name in LENET_NAMES or name.startswith("resnet")):
        raise ValueError(
            f"precision.matmul_dtype='int8' is wired for the dense/conv "
            f"image models (lenet, resnet), not {config.name!r}")


def _dtype(config: ModelConfig, precision) -> torch.dtype:
    if precision is not None and precision.activation_dtype:
        return _ACTIVATION_DTYPES[precision.activation_dtype]
    return _DTYPES[config.dtype]


def _ckpt_policy(precision) -> str | None:
    if precision is None or precision.remat_policy == "none":
        return None
    return precision.remat_policy


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
    if config.remat and config.pipeline_stages > 1:
        raise ValueError(
            "model.remat inside the pipelined stack is unsupported — the "
            "GPipe stage body manages its own activation lifetime")
    if config.space_to_depth_stem and not is_resnet:
        raise ValueError(
            f"model.space_to_depth_stem is a ResNet ImageNet-stem "
            f"optimization, not supported for {config.name!r}")
    if config.dtype not in _DTYPES:
        raise ValueError(f"model.dtype {config.dtype!r} not in "
                         f"{sorted(_DTYPES)}")


def model_kwargs(config: ModelConfig, precision=None) -> dict:
    """BertForMLM constructor arguments for ``config`` under
    ``precision``; raises for what the JAX package refuses."""
    if config.name.lower() not in BERT_NAMES:
        raise ValueError(f"{config.name!r} is not a BERT model")
    check_precision(config, precision)
    _check_common(config, config.name.lower())
    if config.pipeline_stages > 1:
        if config.num_experts > 0:
            raise ValueError(
                "MoE inside the pipelined stack is unsupported "
                "(num_experts>0 with pipeline_stages>1) — the stage "
                "shard_map would need manual expert collectives")
        if config.attention_impl == "ring":
            raise ValueError(
                "attention_impl='ring' nests a shard_map inside the "
                "pipeline shard_map — unsupported; use 'xla' or 'pallas' "
                "with PP")
    return dict(
        vocab_size=config.vocab_size, hidden_size=config.hidden_size,
        num_layers=config.num_layers, num_heads=config.num_heads,
        mlp_dim=config.mlp_dim, max_seq_len=config.max_seq_len,
        dropout_rate=config.dropout_rate, dtype=_dtype(config, precision),
        attention_impl=config.attention_impl, fused_qkv=config.fused_qkv,
        remat=config.remat, ckpt_policy=_ckpt_policy(precision),
        num_experts=config.num_experts,
        moe_every=config.moe_every, expert_topk=config.expert_topk,
        capacity_factor=config.capacity_factor,
        moe_dispatch=config.moe_dispatch,
        moe_zloss_weight=config.moe_zloss_weight)


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
                in_channels: int | None = None, precision=None) -> nn.Module:
    """The uninitialised module for ``config`` on ``device`` (BERT whole,
    whatever ``model.pipeline_stages``) under ``precision`` (None: the
    model as configured, the serving path). ``in_channels`` (the data's
    ``channels``) defaults to 1 for LeNet and 3 for ResNet and
    Inception."""
    name = config.name.lower()
    if name in BERT_NAMES:
        from distributed_tensorflow_framework_torch.models.bert import (
            BertForMLM,
        )

        return BertForMLM(**model_kwargs(config, precision), device=device)
    check_precision(config, precision)
    _check_common(config, name)
    dtype = _dtype(config, precision)
    matmul_dtype = "" if precision is None else precision.matmul_dtype
    if name in LENET_NAMES:
        from distributed_tensorflow_framework_torch.models.lenet import LeNet5

        return LeNet5(config.num_classes, in_channels=in_channels or 1,
                      dtype=dtype, matmul_dtype=matmul_dtype, device=device)
    m = _RESNET.fullmatch(name)
    if m:
        from distributed_tensorflow_framework_torch.models.resnet import (
            make_resnet,
        )

        return make_resnet(int(m.group(1)), config.num_classes, dtype=dtype,
                           cifar_stem=m.group(2) is not None,
                           space_to_depth_stem=config.space_to_depth_stem,
                           in_channels=in_channels or 3, remat=config.remat,
                           remat_policy=config.remat_policy,
                           ckpt_policy=_ckpt_policy(precision),
                           matmul_dtype=matmul_dtype, device=device)
    if name in INCEPTION_NAMES:
        from distributed_tensorflow_framework_torch.models.inception import (
            InceptionV3,
        )

        return InceptionV3(config.num_classes, in_channels=in_channels or 3,
                           remat=config.remat,
                           ckpt_policy=_ckpt_policy(precision), dtype=dtype,
                           device=device)
    raise ValueError(f"Unknown model {config.name!r}")


def get_model(config: ModelConfig, *, device: str | torch.device = "cuda",
              generator: torch.Generator | None = None,
              in_channels: int | None = None, runtime=None,
              precision=None) -> nn.Module:
    """Build the model on ``device`` (default CUDA; raises when CUDA is
    absent unless ``device="cpu"``) — a registered model from its builder
    (:func:`register_model`), which draws its own parameters — under
    ``precision`` (the config's
    ``PrecisionConfig``, or None) with its parameters drawn from
    ``generator`` (default: seed 0 on that device), in f32 whatever the
    precision. Eval mode: the trainer switches it to ``train()``. Image
    models on a CUDA device are laid out channels_last. With
    ``model.pipeline_stages > 1`` the whole BERT so drawn is cut to
    ``runtime``'s stage (``PipelinedBert``, each layer checkpointed with
    ``precision.remat_policy`` when set; a ValueError without a runtime,
    as the JAX package's needs the mesh)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if config.name.lower() in _CUSTOM_MODELS:
        return _build_custom(config, dev, generator, precision).eval()
    model = build_model(config, device=dev, in_channels=in_channels,
                        precision=precision)
    model.init_weights(generator)
    if dev.type == "cuda" and config.name.lower() not in BERT_NAMES:
        model = model.to(memory_format=torch.channels_last)
    if config.name.lower() in BERT_NAMES and config.pipeline_stages > 1:
        from distributed_tensorflow_framework_torch.parallel.pipeline import (
            PipelinedBert,
        )

        model = PipelinedBert(
            model, runtime, num_stages=config.pipeline_stages,
            num_microbatches=config.pipeline_microbatches,
            schedule=config.pipeline_schedule,
            virtual_stages=config.pipeline_virtual_stages,
            model_kwargs=model_kwargs(config, precision),
            ckpt_policy=_ckpt_policy(precision))
    return model.eval()
