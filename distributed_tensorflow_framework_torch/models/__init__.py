"""Model registry: ``get_model`` from a ModelConfig.

Port of ``models/__init__.py``'s dispatch for the ``bert`` names. Every
configuration the port cannot build yet raises NotImplementedError naming
the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_framework_torch.core.config import ModelConfig
from distributed_tensorflow_framework_torch.core.device import resolve_device
from distributed_tensorflow_framework_torch.models.bert import BertForMLM

BERT_NAMES = ("bert", "bert_base", "bert-base")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_kwargs(config: ModelConfig) -> dict:
    """BertForMLM constructor arguments for ``config``; raises for what the
    port does not support yet."""
    name = config.name.lower()
    if name not in BERT_NAMES:
        raise NotImplementedError(
            f"model {config.name!r} is not ported yet — ROADMAP.md queue A "
            f"(LeNet-5: item A2, ResNet: A5, Inception-v3: A6)")
    if config.num_experts > 0:
        raise NotImplementedError(
            "MoE encoder layers (model.num_experts>0) are not ported yet — "
            "ROADMAP.md queue A item A8")
    if config.pipeline_stages > 1:
        raise NotImplementedError(
            "pipelined BERT (model.pipeline_stages>1) is not ported yet — "
            "ROADMAP.md queue A item A12")
    if config.attention_impl == "ring":
        raise NotImplementedError(
            "attention_impl='ring' is not ported yet — ROADMAP.md queue A "
            "item A11 (sequence parallel)")
    if config.remat_policy != "full":
        # The JAX package's message: conv_saved keys on the ResNet ConvBN
        # tag, and BERT refuses it rather than ignore it.
        raise ValueError(
            f"model.remat_policy={config.remat_policy!r} requires "
            f"model.remat=true on a resnet model (the conv_saved policy "
            f"keys on the ConvBN conv_out tag)")
    if config.dtype not in _DTYPES:
        raise ValueError(f"model.dtype {config.dtype!r} not in "
                         f"{sorted(_DTYPES)}")
    return dict(
        vocab_size=config.vocab_size, hidden_size=config.hidden_size,
        num_layers=config.num_layers, num_heads=config.num_heads,
        mlp_dim=config.mlp_dim, max_seq_len=config.max_seq_len,
        dropout_rate=config.dropout_rate, dtype=_DTYPES[config.dtype],
        attention_impl=config.attention_impl, fused_qkv=config.fused_qkv,
        remat=config.remat)


def get_model(config: ModelConfig, *, device: str | torch.device = "cuda",
              generator: torch.Generator | None = None) -> BertForMLM:
    """Build the model on ``device`` (default CUDA; raises when CUDA is
    absent unless ``device="cpu"``) with its parameters drawn from
    ``generator`` (default: seed 0 on that device). Eval mode: the
    trainer switches it to ``train()``."""
    dev = resolve_device(device)
    model = BertForMLM(**model_kwargs(config), device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model.init_weights(generator)
    return model.eval()
