"""The traffic generator: a training batch from a traffic file's
parameters, the run's seed, the rank and the batch's index.

The traffic file's ``kind`` names the generator of its rows,
``kinds/<kind>.py`` (``make_batch``, ``real_tokens``, ``overrides``): a
later change adds a kind as a new file. Batches are made on the device
with a ``torch.Generator`` seeded from (seed, data, rank, index), so the
reference can make the same rows again; :func:`host_pool` brings
``pool_batches`` of them to the host once, in set-up, and the dataset
cycles through that pool.
"""

from __future__ import annotations

import torch

from benchlib import seeds, spec


def rows_per_step(traffic: dict, chips: int) -> int:
    return int(traffic["rows_per_chip"]) * chips


def dataset_name(traffic: dict) -> str:
    """The name the benchmark's dataset is registered under for this
    kind (``synthetic*`` and the built-ins are the program's)."""
    return "benchmark_" + traffic["kind"]


def make_batch(traffic: dict, data: dict, seed: int, rank: int, index: int,
               device) -> dict[str, torch.Tensor]:
    """Batch ``index`` of rank ``rank`` on ``device``. ``data`` is the
    experiment's data section (vocabulary, image size, classes)."""
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, seeds.DATA, rank, index))
    return spec.kind(traffic["kind"]).make_batch(traffic, data, gen, device)


def real_tokens(traffic: dict, batch: dict) -> int:
    """Non-padding tokens of a batch (0 where the kind has no tokens)."""
    return spec.kind(traffic["kind"]).real_tokens(batch)


def overrides(traffic: dict) -> list[str]:
    """The experiment's data settings that the kind's rows fix."""
    return spec.kind(traffic["kind"]).overrides(traffic)


def host_pool(traffic: dict, data: dict, seed: int, rank: int,
              device) -> list[dict[str, torch.Tensor]]:
    """The rank's pool of host batches, made on ``device`` and copied to
    the host once."""
    return [{k: v.cpu() for k, v in
             make_batch(traffic, data, seed, rank, i, device).items()}
            for i in range(int(traffic["pool_batches"]))]
