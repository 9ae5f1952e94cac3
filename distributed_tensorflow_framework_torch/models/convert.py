"""Carry weights between a Flax parameter tree and the port's state_dict.

The port's modules are named after the Flax tree, so the mapping is by name
with four layout rules:

  * Dense ``kernel`` (in, *out) → Linear ``weight`` (prod(out), in): the
    transpose of the kernel flattened to 2-D. The fused ``qkv`` kernel
    (H, 3, H) becomes (3H, H), row ``c*H + o`` holding column (c, o);
  * Dense ``bias`` (*out) → flat (prod(out),), so the fused (3, H) → (3H,);
  * LayerNorm ``scale`` → ``weight``; Embed ``embedding`` → ``weight``;
  * everything else (``pos_embedding``, ``mlm_bias``, LayerNorm ``bias``)
    keeps its name and shape.

Trees are nested dicts of numpy arrays, as ``jax.device_get`` of the Flax
params gives them and as serve/export.py stores them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_framework_torch.models.layers import (
    Dense,
    LayerNorm,
)


def flatten_tree(tree: dict[str, Any], prefix: tuple = ()) -> dict[tuple, Any]:
    """Nested dict → {path tuple: leaf}, keys visited in sorted order."""
    out: dict[tuple, Any] = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(flatten_tree(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def unflatten_tree(flat: dict[tuple, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def flax_to_state_dict(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves) → the port's state_dict (f32 CPU
    tensors; ``load_state_dict`` moves them to the model's device)."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in flatten_tree(params).items():
        arr = np.asarray(leaf, dtype=np.float32)
        *mods, name = path
        if name == "kernel":
            arr, name = arr.reshape(arr.shape[0], -1).T, "weight"
        elif name == "bias":  # the fused (3, H) Dense bias; 1-D stays
            arr = arr.reshape(-1)
        elif name in ("scale", "embedding"):
            name = "weight"
        out[".".join((*mods, name))] = torch.tensor(arr)  # a copy
    return out


def flax_layout(model: nn.Module) -> dict[str, tuple[tuple[str, ...],
                                                     tuple[int, ...]]]:
    """Each state_dict key of the port model → (its Flax path, the Flax
    leaf's shape), with layouts taken from the module types (a Dense's
    Flax kernel shape is (in, *out), where the fused ``qkv`` output is
    (3, H))."""
    modules = dict(model.named_modules())
    out = {}
    for key, tensor in model.state_dict().items():
        *mods, name = key.split(".")
        owner = modules[".".join(mods)]
        shape = tuple(tensor.shape)
        if isinstance(owner, Dense):
            out_shape = ((3, shape[0] // 3) if mods[-1] == "qkv"
                         else (shape[0],))
            if name == "weight":
                name, shape = "kernel", (shape[1], *out_shape)
            else:
                shape = out_shape
        elif isinstance(owner, LayerNorm) and name == "weight":
            name = "scale"
        elif name == "weight":  # Embed
            name = "embedding"
        out[key] = ((*mods, name), shape)
    return out


def to_flax(model: nn.Module,
            tensors: dict[str, torch.Tensor] | None = None) -> dict[str, Any]:
    """The port model's parameters as a Flax tree of f32 numpy arrays — the
    inverse of :func:`flax_to_state_dict`. ``tensors`` (state_dict key →
    tensor of the parameter's shape, e.g. gradients or updates) are laid
    out instead of the parameters when given."""
    tensors = model.state_dict() if tensors is None else tensors
    flat: dict[tuple, np.ndarray] = {}
    for key, (path, shape) in flax_layout(model).items():
        arr = tensors[key].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            arr = arr.T
        flat[path] = np.ascontiguousarray(arr.reshape(shape))
    return unflatten_tree(flat)
