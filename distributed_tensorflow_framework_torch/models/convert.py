"""Carry weights between a Flax parameter tree and the port's state_dict.

The port's modules are named after the Flax tree, so the mapping is by name
with these layout rules:

  * Dense ``kernel`` (in, *out) → Linear ``weight`` (prod(out), in): the
    transpose of the kernel flattened to 2-D. The fused ``qkv`` kernel
    (H, 3, H) becomes (3H, H), row ``c*H + o`` holding column (c, o);
  * Dense ``bias`` (*out) → flat (prod(out),), so the fused (3, H) → (3H,);
  * Conv ``kernel`` (kh, kw, cin, cout) → ``weight`` (cout, cin, kh, kw);
  * LayerNorm and BatchNorm ``scale`` → ``weight``; Embed ``embedding`` →
    ``weight``;
  * a ConvBN's ``BatchNorm_0/bn`` → the port's ``bn`` module, and the
    Flax ``batch_stats`` tree's ``mean``/``var`` → its ``running_mean``/
    ``running_var`` buffers;
  * everything else (``pos_embedding``, ``mlm_bias``, biases, and a MoE
    layer's ``moe/wi`` (E, H, F) and ``moe/wo`` (E, F, H), which are not
    Dense kernels and keep the Flax layout) keeps its name and shape; the
    MoE gate is a Dense without bias (``moe/gate/kernel`` (H, E) → (E, H)).

Trees are nested dicts of numpy arrays, as ``jax.device_get`` of the Flax
params (and ``batch_stats``) gives them and as serve/export.py stores them.

Under tensor parallelism (parallel/tensor_parallel.py) a rank holds the
part of a leaf that the JAX package's ``PartitionSpec`` gives its
``model`` coordinate: the Flax leaf cut into equal blocks along one dim
(:func:`leaf_part`, and :func:`leaf_whole` the inverse). A part maps onto
the port's layout by the same rules as a whole leaf (:func:`torch_shape`):
the fused ``qkv`` kernel's part (H, 3, H/m) is a (3H/m, H) weight whose
rows ``i·H/m + o`` hold the whole weight's rows ``i·H + r·H/m + o``.
Under expert parallelism (parallel/expert.py) the part of ``wi``/``wo``
at ``expert`` coordinate r is ``leaf_part(leaf, 0, n, r)``, experts
``[r·E/n, (r+1)·E/n)``, in the same layout as the whole leaf.

The JAX package's pipelined BERT (parallel/pipeline.py) keeps its
encoder layers stacked: ``{embed_block, pipeline_layers, head}``, every
leaf of ``pipeline_layers`` with a leading dim of L, row g layer g.
:func:`unstack_pipeline` turns that tree into the whole BERT tree
(``layer{g}``), which maps onto a ``BertForMLM`` or, key for key, onto
the stages of the port's ``PipelinedBert`` (which keep the whole model's
names), and :func:`stack_pipeline` is its inverse. :func:`pipeline_part`
is a stage's part of the stack: the rows the JAX package places on
``pipe`` coordinate s, its ``L/S`` contiguous rows, or under the
interleaved schedule its v round-robin chunks (the rows permuted by
``_interleave_perm`` first). Whatever the schedule, the stored layer
order is the natural one.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_framework_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    LayerNorm,
)

# A ConvBN's BatchNorm in the Flax tree, and its port module name.
_FLAX_BN = ("BatchNorm_0", "bn")
_STATS = {"mean": "running_mean", "var": "running_var"}


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


def flax_to_state_dict(params: dict[str, Any],
                       batch_stats: dict[str, Any] | None = None
                       ) -> dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves), and the ``batch_stats`` tree of
    a BN model, → the port's state_dict (f32 CPU tensors;
    ``load_state_dict`` moves them to the model's device)."""
    out: dict[str, torch.Tensor] = {}
    leaves = [(path, leaf, False) for path, leaf in
              flatten_tree(params).items()]
    leaves += [(path, leaf, True) for path, leaf in
               flatten_tree(batch_stats or {}).items()]
    for path, leaf, is_stat in leaves:
        arr = np.asarray(leaf, dtype=np.float32)
        *mods, name = path
        if tuple(mods[-2:]) == _FLAX_BN:
            mods = [*mods[:-2], "bn"]
        if is_stat:
            name = _STATS[name]
        elif name == "kernel" and arr.ndim == 4:  # Conv
            arr, name = arr.transpose(3, 2, 0, 1), "weight"
        elif name == "kernel":
            arr, name = arr.reshape(arr.shape[0], -1).T, "weight"
        elif name == "bias":  # the fused (3, H) Dense bias; 1-D stays
            arr = arr.reshape(-1)
        elif name in ("scale", "embedding"):
            name = "weight"
        out[".".join((*mods, name))] = torch.tensor(arr)  # a copy
    return out


def flax_layout(model: nn.Module) -> dict[str, tuple[tuple[str, ...],
                                                     tuple[int, ...]]]:
    """Each parameter's state_dict key in the port model → (its Flax path,
    the Flax leaf's shape), with layouts taken from the module types (a
    Dense's Flax kernel shape is (in, *out), where the fused ``qkv``
    output is (3, H); a Conv's is (kh, kw, cin, cout))."""
    modules = dict(model.named_modules())
    out = {}
    for key, tensor in model.named_parameters():
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
        elif isinstance(owner, Conv) and name == "weight":
            name, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
        elif isinstance(owner, BatchNorm):
            mods = [*mods[:-1], *_FLAX_BN]
            name = "scale" if name == "weight" else name
        elif isinstance(owner, LayerNorm) and name == "weight":
            name = "scale"
        elif name == "weight":  # Embed
            name = "embedding"
        out[key] = ((*mods, name), shape)
    return out


def flax_stats_layout(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """Each BatchNorm running buffer's state_dict key → its path in the
    Flax ``batch_stats`` tree."""
    renames = {v: k for k, v in _STATS.items()}
    out = {}
    for key, module in model.named_modules():
        if isinstance(module, BatchNorm):
            mods = [*key.split(".")[:-1], *_FLAX_BN]
            for buf, name in renames.items():
                out[f"{key}.{buf}"] = (*mods, name)
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
        if path[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif path[-1] == "kernel":
            arr = arr.T
        flat[path] = np.ascontiguousarray(arr.reshape(shape))
    return unflatten_tree(flat)


def batch_stats_to_flax(model: nn.Module) -> dict[str, Any]:
    """The BN running statistics as the Flax ``batch_stats`` tree ({} for
    a model without BN)."""
    state = model.state_dict()
    return unflatten_tree({
        path: state[key].detach().to("cpu", torch.float32).numpy().copy()
        for key, path in flax_stats_layout(model).items()})


def torch_shape(path: tuple[str, ...], flax_shape: tuple[int, ...]
                ) -> tuple[int, ...]:
    """The shape of the port tensor that holds a Flax leaf (or a part of
    one) of ``flax_shape`` at ``path``: a Dense kernel (in, *out) is a
    (prod(out), in) weight, a Conv kernel (kh, kw, cin, cout) a (cout, cin,
    kh, kw) weight, a Dense bias (*out) flat, everything else as it is."""
    if path[-1] == "kernel" and len(flax_shape) == 4:
        kh, kw, cin, cout = flax_shape
        return (cout, cin, kh, kw)
    if path[-1] == "kernel":
        return (int(np.prod(flax_shape[1:])), flax_shape[0])
    if path[-1] == "bias":
        return (int(np.prod(flax_shape)),)
    return tuple(flax_shape)


def leaf_part(leaf: np.ndarray, dim: int, count: int,
              index: int) -> np.ndarray:
    """Block ``index`` of ``count`` equal blocks of a Flax leaf along
    ``dim``: the part a ``PartitionSpec`` naming one axis of size
    ``count`` on ``dim`` gives the member at coordinate ``index``."""
    return np.split(np.asarray(leaf), count, axis=dim)[index]


def leaf_whole(parts, dim: int) -> np.ndarray:
    """The Flax leaf from its :func:`leaf_part` blocks, in member order."""
    return np.concatenate([np.asarray(p) for p in parts], axis=dim)


PIPELINE_STACK = "pipeline_layers"


def unstack_pipeline(tree: dict[str, Any]) -> dict[str, Any]:
    """A pipelined Flax tree ``{embed_block, pipeline_layers, head}`` →
    the whole BERT tree, stack row g as ``layer{g}``."""
    out = {k: v for k, v in tree.items() if k != PIPELINE_STACK}
    flat = flatten_tree(tree[PIPELINE_STACK])
    rows = len(next(iter(flat.values())))
    for g in range(rows):
        out[f"layer{g}"] = unflatten_tree(
            {path: np.asarray(leaf)[g] for path, leaf in flat.items()})
    return out


def stack_pipeline(tree: dict[str, Any]) -> dict[str, Any]:
    """The inverse of :func:`unstack_pipeline`: the ``layer{g}`` subtrees
    of a whole BERT tree stacked on a leading dim, row g layer g."""
    layers = sorted((k for k in tree if k.startswith("layer")),
                    key=lambda k: int(k[len("layer"):]))
    out = {k: v for k, v in tree.items() if not k.startswith("layer")}
    flats = [flatten_tree(tree[k]) for k in layers]
    out[PIPELINE_STACK] = unflatten_tree({
        path: np.stack([np.asarray(f[path]) for f in flats])
        for path in flats[0]})
    return out


def pipeline_part(stack: dict[str, Any], stages: int, virtual: int,
                  index: int) -> tuple[list[int], dict[str, Any]]:
    """Stage ``index``'s part of a stacked ``pipeline_layers`` tree (as the
    JAX package places it: the rows permuted by ``_interleave_perm`` under
    the interleaved schedule, then block ``index`` of ``stages``): the
    global layers of its rows, in row order, and those rows."""
    from distributed_tensorflow_framework_torch.parallel.pipeline import (
        interleave_perm,
    )

    flat = flatten_tree(stack)
    rows = len(next(iter(flat.values())))
    per = rows // stages
    layers = interleave_perm(rows, stages, virtual)[
        index * per:(index + 1) * per]
    return layers, unflatten_tree({
        path: np.asarray(leaf)[layers] for path, leaf in flat.items()})
