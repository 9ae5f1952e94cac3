"""The weights both sides start from, made by the benchmark from the seed.

A reference module lists its parameters as ``name -> (shape, init)``
with ``init`` one of ``("normal", std)``, ``("ones",)`` or
``("zeros",)``. Every normal leaf is cut from one standard-normal draw of
all of them together, made on the device with a ``torch.Generator`` in
f32 (the type the program keeps its parameters in) and scaled in place.
"""

from __future__ import annotations

import math

import torch

from benchlib import seeds


def make(specs: dict, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, seeds.WEIGHTS))
    normal = [(n, s) for n, (s, init) in specs.items() if init[0] == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, offset = {}, 0
    for name, (shape, init) in specs.items():
        if init[0] == "normal":
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(init[1])
            offset += n
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out
