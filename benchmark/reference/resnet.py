"""ResNet-50 ImageNet training in plain PyTorch, f32: the reference of
the ``resnet50-imagenet`` configuration.

He et al. 2015 (arXiv:1512.03385), table 1, as the configuration runs it:
bottleneck blocks of [3, 4, 6, 3] at widths 64·2^s with the stride on
the 3×3 conv (the "v1.5" placement; the paper puts it on the first 1×1),
a projection conv + BN where a block changes the shape, BatchNorm in
training mode after every conv (batch statistics, biased variance, ε
1e-5; running statistics ← 0.9·old + 0.1·batch), ReLU, the global mean,
and a 1000-way classifier with a bias. Padding is TensorFlow's SAME (at
stride 2 one pixel after, none before). With ``space_to_depth_stem`` the
7×7/s2 stem conv is replaced by its space-to-depth form: the image as
2×2 blocks stacked on the channels (pixel (2i+di, 2j+dj, c) at channel
(2·di + dj)·3 + c), a 4×4/s1 conv padded (1, 2) on both axes, which
spans the same function class as the 7×7/s2 conv with 12,288 weights in
place of 9,408; then the 3×3/s2 max-pool. Loss: softmax cross-entropy
against labels smoothed by ``label_smoothing``, the mean over the batch.
Update: SGD with momentum (the trace starts at the first step's
gradient), weight decay added to the gradient of rank ≥ 2 leaves before
the trace, the schedule's learning rate at the step before the update.

The stem and every block are recomputed in the backward
(``torch.utils.checkpoint``) so that a global batch of 1024 fits one
card; the running statistics come from the forward. Imports nothing of
the program. f32, TF32 off; ``quant="fp8"`` is the control, fp8 where the
configuration computes in bf16 (reference/common.py ``Ops``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import (decays, exact_f32, leaf_norms, learning_rate,
                              Ops)

STAGES = {50: (3, 4, 6, 3)}
BN_EPS = 1e-5
BN_KEEP = 0.9
WIDTH = 64
EXPANSION = 4
LAST_BN_STD = 0.2


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TensorFlow's SAME padding along one axis (the smaller half first)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _depth(exp: dict) -> int:
    name = exp["model"]["name"].lower()
    depth = int(name.removeprefix("resnet"))
    if depth not in STAGES:
        raise ValueError(f"no reference for {name}")
    return depth


def convs(exp: dict, image: int, *, stem: str | None = None,
          stride_on: str = "3x3") -> list[dict]:
    """Every conv of the network in order: name (its ConvBN's parameter
    prefix), cin, cout, k, stride, pads ((top, bottom), (left, right)), the
    input's and the output's side. ``stem``: "s2d" or "7x7" (default: the
    configuration's); ``stride_on``: where a downsampling block puts its
    stride ("1x1" is the paper's placement, for the FLOP test)."""
    m = exp["model"]
    channels = exp["data"]["channels"]
    stem = stem or ("s2d" if m["space_to_depth_stem"] else "7x7")
    out = []
    if stem == "s2d":
        side = image // 2
        out.append(dict(name="stem_s2d", cin=4 * channels, cout=WIDTH, k=4,
                        stride=1, pads=((1, 2), (1, 2)), hin=side,
                        hout=side))
    else:
        p = same_pads(image, 7, 2)
        side = -(-image // 2)
        out.append(dict(name="stem", cin=channels, cout=WIDTH, k=7, stride=2,
                        pads=(p, p), hin=image, hout=side))
    side = -(-side // 2)  # the 3×3/s2 max-pool
    cin = WIDTH
    for s, blocks in enumerate(STAGES[_depth(exp)]):
        f = WIDTH * 2 ** s
        for b in range(blocks):
            stride = 2 if s > 0 and b == 0 else 1
            name = f"stage{s + 1}_block{b + 1}"
            s1, s3 = (stride, 1) if stride_on == "1x1" else (1, stride)
            mid = -(-side // s1)
            outside = -(-mid // s3)
            p3 = same_pads(mid, 3, s3)
            out += [
                dict(name=name + ".conv1", cin=cin, cout=f, k=1, stride=s1,
                     pads=((0, 0), (0, 0)), hin=side, hout=mid),
                dict(name=name + ".conv2", cin=f, cout=f, k=3, stride=s3,
                     pads=(p3, p3), hin=mid, hout=outside),
                dict(name=name + ".conv3", cin=f, cout=EXPANSION * f, k=1,
                     stride=1, pads=((0, 0), (0, 0)), hin=outside,
                     hout=outside)]
            if stride != 1 or cin != EXPANSION * f:
                out.append(dict(name=name + ".proj", cin=cin,
                                cout=EXPANSION * f, k=1, stride=stride,
                                pads=((0, 0), (0, 0)), hin=side,
                                hout=outside))
            cin, side = EXPANSION * f, outside
    return out


def features(exp: dict) -> int:
    return WIDTH * 2 ** (len(STAGES[_depth(exp)]) - 1) * EXPANSION


def forward_macs(exp: dict, image: int, **kw) -> int:
    """Multiply-adds of one image's forward: every conv's
    Cin·Cout·k²·Hout·Wout and the classifier's."""
    total = sum(c["cin"] * c["cout"] * c["k"] ** 2 * c["hout"] ** 2
                for c in convs(exp, image, **kw))
    return total + features(exp) * exp["model"]["num_classes"]


def step_flops(exp: dict, batch: dict) -> float:
    """Model FLOPs of one training step: three times the forward's
    2·multiply-adds for every image of ``batch``."""
    image = batch["image"].shape[1]
    return 3.0 * 2.0 * forward_macs(exp, image) * batch["image"].shape[0]


def param_specs(exp: dict) -> dict:
    """name -> (shape, init), in the program's parameter names: convs
    normal with std √(2 / (k²·cout)) (He, fan-out), BatchNorm biases zero
    and scales one, but for the last BatchNorm of each residual branch,
    whose scale is normal with std LAST_BN_STD: small, as the zero start
    of Goyal et al. keeps the blocks near the identity, but not zero, so
    that every conv has a gradient at the first step. The classifier
    normal with std 1/√fan-in and a zero bias."""
    specs = {}
    for c in convs(exp, exp["data"]["image_size"]):
        std = math.sqrt(2.0 / (c["k"] ** 2 * c["cout"]))
        specs[c["name"] + ".conv.weight"] = (
            (c["cout"], c["cin"], c["k"], c["k"]), ("normal", std))
        specs[c["name"] + ".bn.weight"] = (
            (c["cout"],), ("normal", LAST_BN_STD)
            if c["name"].endswith(".conv3") else ("ones",))
        specs[c["name"] + ".bn.bias"] = ((c["cout"],), ("zeros",))
    n, k = exp["model"]["num_classes"], features(exp)
    specs["classifier.weight"] = ((n, k), ("normal", 1.0 / math.sqrt(k)))
    specs["classifier.bias"] = ((n,), ("zeros",))
    return specs


def buffer_specs(exp: dict) -> dict:
    specs = {}
    for c in convs(exp, exp["data"]["image_size"]):
        specs[c["name"] + ".bn.running_mean"] = ((c["cout"],), ("zeros",))
        specs[c["name"] + ".bn.running_var"] = ((c["cout"],), ("ones",))
    return specs


def _conv_bn(P, c, x, stats, ops, relu):
    (t, b), (l, r) = c["pads"]
    x = F.pad(x, (l, r, t, b))
    y = ops.act(ops.conv(x, P[c["name"] + ".conv.weight"], c["stride"]))
    mean = y.mean(dim=(0, 2, 3))
    var = (y - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    stats[c["name"]] = (mean.detach(), var.detach())
    y = ((y - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
         * P[c["name"] + ".bn.weight"][:, None, None]
         + P[c["name"] + ".bn.bias"][:, None, None])
    y = ops.act(y)
    return F.relu(y) if relu else y


def _stem(P, stem, x, stats, ops):
    x = _conv_bn(P, stem, x, stats, ops, True)
    p = same_pads(x.shape[2], 3, 2)
    return F.max_pool2d(F.pad(x, (*p, *p), value=float("-inf")), 3, 2)


def _block(P, layers, x, stats, ops):
    by = {c["name"].rsplit(".", 1)[1]: c for c in layers}
    y = _conv_bn(P, by["conv1"], x, stats, ops, True)
    y = _conv_bn(P, by["conv2"], y, stats, ops, True)
    y = _conv_bn(P, by["conv3"], y, stats, ops, False)
    res = x if "proj" not in by else _conv_bn(P, by["proj"], x, stats, ops,
                                             False)
    return F.relu(ops.act(res + y))


def forward(P: dict, exp: dict, images: torch.Tensor, stats: dict,
            ops) -> torch.Tensor:
    """Logits of NHWC ``images``; each BatchNorm's batch statistics go
    into ``stats`` under its layer's name. ``ops``: reference/common.py
    ``Ops``."""
    layers = convs(exp, images.shape[1])
    x = images.float()
    stem = layers[0]
    if stem["name"] == "stem_s2d":
        n, h, w, ch = x.shape
        x = x.reshape(n, h // 2, 2, w // 2, 2, ch).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, h // 2, w // 2, 4 * ch)
    x = checkpoint(_stem, P, stem, x.permute(0, 3, 1, 2), stats, ops,
                   use_reentrant=False)
    blocks: dict[str, list] = {}
    for c in layers[1:]:
        blocks.setdefault(c["name"].split(".")[0], []).append(c)
    for name, group in blocks.items():
        x = checkpoint(_block, P, group, x, stats, ops, use_reentrant=False)
    x = ops.act(x.mean(dim=(2, 3)))
    return ops.mm(x, P["classifier.weight"].t()) + P["classifier.bias"]


def train_steps(exp: dict, params: dict, buffers: dict, batches: list,
                *, dropout_seed: int = 0, quant: str | None = None) -> dict:
    """Run ``len(batches)`` steps from ``params`` and ``buffers``. Returns
    the loss of each step, each leaf's norm of the first step's gradient,
    and each leaf's and running statistic's norm of its change."""
    ops = Ops(quant)
    opt = exp["optimizer"]
    if opt["name"] not in ("sgd", "sgd_momentum", "momentum"):
        raise ValueError("the ResNet reference updates with SGD momentum")
    if opt.get("nesterov"):
        raise ValueError("no Nesterov momentum in the reference")
    mu, wd, clip = opt["momentum"], opt["weight_decay"], opt["grad_clip_norm"]
    smoothing = exp["train"]["label_smoothing"]
    total_steps = exp["train"]["total_steps"]
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    B = {k: v.detach().clone() for k, v in buffers.items()}
    trace = {}
    losses, first_grads = [], None
    with exact_f32():
        for t, batch in enumerate(batches):
            stats: dict = {}
            logits = forward(P, exp, batch["image"], stats, ops)
            loss = F.cross_entropy(logits, batch["label"].long(),
                                   label_smoothing=smoothing)
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                grads = {k: p.grad for k, p in P.items()}
                if clip > 0:
                    norm = torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(g) for g in grads.values()]))
                    scale = (clip / norm).clamp(max=1.0)
                    for g in grads.values():
                        g.mul_(scale)
                if t == 0:
                    first_grads = leaf_norms(grads)
                lr = learning_rate(opt, total_steps, t)
                for k, p in P.items():
                    d = grads[k] + wd * p if decays(p.shape) else grads[k]
                    trace[k] = (d.clone() if t == 0
                                else trace[k].mul_(mu).add_(d))
                    p.sub_(lr * trace[k])
                    p.grad = None
                for name, (mean, var) in stats.items():
                    rm, rv = (B[name + ".bn.running_mean"],
                              B[name + ".bn.running_var"])
                    rm.mul_(BN_KEEP).add_(mean, alpha=1.0 - BN_KEEP)
                    rv.mul_(BN_KEEP).add_(var, alpha=1.0 - BN_KEEP)
    with torch.no_grad():
        change = leaf_norms({k: P[k].detach() - start[k] for k in P})
        change.update(leaf_norms({k: B[k] - buffers[k] for k in B}))
    return {"losses": losses, "grad_norms": first_grads,
            "change_norms": change}
