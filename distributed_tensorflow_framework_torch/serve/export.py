"""Serving artifacts: save and load, with the integrity manifest.

An artifact is a directory holding exactly what inference needs:

    <artifact>/
      artifact.json   — schema, model config, task, step, input spec,
                        sha256 digest of the param tree's spec
      params.npz      — the parameters in the Flax tree layout, one array
                        per leaf, keyed by the "/"-joined tree path, and
                        an image model's BatchNorm statistics (the Flax
                        ``batch_stats`` tree) under ``batch_stats/``
      manifest.json   — ckpt/manifest.py integrity commit record over the
                        whole directory

The fields of ``artifact.json`` and the manifest are the JAX package's
(``serve/export.py``); the parameters are one ``.npz`` instead of an orbax
checkpoint, because orbax needs JAX. The schema string differs, so each
package's loader refuses the other's artifact by name. ``load_artifact``
checks the manifest and the spec digest, then converts the tree to the
port's state_dict layout (models/convert.py) on every load.
``export_checkpoint`` freezes a committed training checkpoint of the port
(ckpt/checkpoint.py) into such an artifact, for either task: the mlm
(BERT) one and the classification one (LeNet, ResNet, Inception-v3, a
registered image model), whose artifact carries the running statistics,
and with ``serve.use_ema`` the EMA parameters in place of the trained
ones.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Any

import numpy as np

from distributed_tensorflow_framework_torch.ckpt import manifest as mf
from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
    CheckpointManager,
)
from distributed_tensorflow_framework_torch.core.config import (
    ExperimentConfig,
    ModelConfig,
    _build,
)
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models.convert import (
    batch_stats_to_flax,
    flatten_tree,
    flax_to_state_dict,
    to_flax,
    unflatten_tree,
)

log = logging.getLogger(__name__)

ARTIFACT_SCHEMA = "dtf-torch-serve-artifact/1"
ARTIFACT_JSON = "artifact.json"
PARAMS_NPZ = "params.npz"
# The key prefix of the BatchNorm statistics in PARAMS_NPZ.
_STATS_PREFIX = "batch_stats"


def param_tree_digest(tree: dict[str, Any]) -> str:
    """sha256 over every leaf's (tree path, shape, dtype), in the JAX
    package's exact format (``['a']['b']=(2, 3):float32``), so one tree
    gives one digest in both packages."""
    h = hashlib.sha256()
    for path, leaf in flatten_tree(tree).items():
        arr = np.asarray(leaf)
        keystr = "".join(f"[{k!r}]" for k in path)
        h.update(f"{keystr}={tuple(arr.shape)}:{arr.dtype}\n".encode())
    return h.hexdigest()


def artifact_content_digest(manifest: dict) -> str:
    """sha256 over the manifest's (file, sha256) records — changes
    whenever any payload byte changes."""
    h = hashlib.sha256()
    for rel in sorted(manifest.get("files") or {}):
        h.update(f"{rel}:{manifest['files'][rel].get('sha256')}\n".encode())
    return h.hexdigest()


def input_spec_for(config: ExperimentConfig, task: str) -> dict[str, Any]:
    """Per-ROW request spec recorded in the artifact: what a client must
    send per example (the server's /healthz exposes it)."""
    if task == "mlm":
        seq = int(config.data.seq_len or config.model.max_seq_len)
        return {
            "input_ids": {"shape": [seq], "dtype": "int32"},
            "attention_mask": {"shape": [seq], "dtype": "int32"},
        }
    return {
        "image": {
            "shape": [int(config.data.image_size),
                      int(config.data.image_size),
                      int(config.data.channels)],
            "dtype": "float32",
        },
    }


@dataclasses.dataclass
class Artifact:
    """A loaded serving artifact: the parameters (and BatchNorm
    statistics) as the port's state_dict, converted from the stored Flax
    trees, and the recorded meta."""

    model_config: ModelConfig
    task: str
    state_dict: dict
    step: int
    param_spec_digest: str
    input_spec: dict[str, Any]
    meta: dict[str, Any]
    content_digest: str = ""

    @property
    def vocab_size(self) -> int:
        return int(self.meta.get("vocab_size") or
                   self.model_config.vocab_size)

    @property
    def version_digest(self) -> str:
        return self.content_digest or self.param_spec_digest


def save_artifact(
    output_dir: str,
    *,
    model_config: ModelConfig,
    task: str,
    params: dict[str, Any],
    step: int,
    input_spec: dict[str, Any],
    source: dict[str, Any] | None = None,
    batch_stats: dict[str, Any] | None = None,
) -> str:
    """Write an artifact from a Flax-layout tree of numpy arrays
    (models/convert.to_flax of a port model, or ``jax.device_get`` of the
    JAX package's params) and, for a BatchNorm model, its ``batch_stats``
    tree (models/convert.batch_stats_to_flax). Refuses a non-empty target
    — an artifact is immutable once committed."""
    out = os.path.abspath(output_dir)
    if os.path.isdir(out) and os.listdir(out):
        raise ValueError(
            f"artifact directory {out} already exists and is not empty — "
            f"artifacts are immutable; export to a fresh directory"
        )
    os.makedirs(out, exist_ok=True)
    flat = {"/".join(path): np.asarray(leaf)
            for path, leaf in flatten_tree(params).items()}
    flat.update({"/".join((_STATS_PREFIX, *path)): np.asarray(leaf)
                 for path, leaf in flatten_tree(batch_stats or {}).items()})
    np.savez(os.path.join(out, PARAMS_NPZ), **flat)
    meta = {
        "schema": ARTIFACT_SCHEMA,
        "task": task,
        "step": int(step),
        "model": dataclasses.asdict(model_config),
        "param_spec_digest": param_tree_digest(params),
        "input_spec": input_spec,
        "vocab_size": int(model_config.vocab_size),
        "exported_t": time.time(),
        "source": source or {},
    }
    with open(os.path.join(out, ARTIFACT_JSON), "w") as fh:
        json.dump(meta, fh, indent=2, sort_keys=True)
        fh.write("\n")
    mf.write_manifest(out, step)
    log.info("exported serving artifact to %s (step %d, %s)", out, step, task)
    return out


def export_checkpoint(config: ExperimentConfig, output_dir: str, *,
                      step: int | None = None,
                      device: str = "cuda") -> str:
    """Freeze the model of a committed checkpoint in
    ``config.checkpoint.directory`` (``step``, default the newest that
    verifies, through the same integrity checks and quarantine as a
    restore) into a serving artifact at ``output_dir``: the task from
    ``task_for_model``, the parameters (the EMA's under ``serve.use_ema``
    when the checkpoint holds one), an image model's BatchNorm statistics,
    and the task's ``input_spec_for``. The model is built from
    ``config.model`` on ``device`` (default CUDA, which it needs unless
    ``device="cpu"``); only its tensors are read, so a checkpoint trained
    on either device exports on either. A pipelined model is refused with
    the JAX package's ValueError (a pipelined run's checkpoint holds the
    whole layout: export it with ``model.pipeline_stages`` 1)."""
    from distributed_tensorflow_framework_torch.train.step import (
        task_for_model,
    )

    if config.model.pipeline_stages > 1:
        raise ValueError(
            "export of pipelined models (model.pipeline_stages>1) is not "
            "supported yet — multi-stage serving is the 1F1B slot-table "
            "follow-up (ROADMAP item 3); export from a stage-merged "
            "checkpoint instead")
    if not config.checkpoint.directory:
        raise ValueError("checkpoint.directory must name the trained run "
                         "to export")
    task = task_for_model(config.model.name)
    model = get_model(config.model, device=device,
                      in_channels=(None if task == "mlm"
                                   else config.data.channels))
    manager = CheckpointManager(dataclasses.replace(config.checkpoint,
                                                    async_save=False))
    try:
        restored = manager.restore_model(model, step=step,
                                         use_ema=config.serve.use_ema)
    finally:
        manager.close()
    if restored is None:
        raise ValueError(f"no committed checkpoint to export in "
                         f"{config.checkpoint.directory}")
    restored_step, used_ema = restored
    return save_artifact(
        output_dir, model_config=config.model, task=task,
        params=to_flax(model), batch_stats=batch_stats_to_flax(model),
        step=restored_step, input_spec=input_spec_for(config, task),
        source={"checkpoint_dir": os.path.abspath(
                    config.checkpoint.directory),
                "experiment": config.name, "used_ema": used_ema})


def load_artifact(artifact_dir: str) -> Artifact:
    """Load + integrity-check a committed artifact."""
    out = os.path.abspath(artifact_dir)
    meta_path = os.path.join(out, ARTIFACT_JSON)
    if not os.path.isfile(meta_path):
        raise ValueError(
            f"{out} is not a serving artifact (no {ARTIFACT_JSON})")
    with open(meta_path) as fh:
        meta = json.load(fh)
    if meta.get("schema") != ARTIFACT_SCHEMA:
        raise ValueError(
            f"artifact schema {meta.get('schema')!r} != {ARTIFACT_SCHEMA!r}"
            f" — this loader reads the PyTorch port's artifacts only"
        )
    manifest = mf.read_manifest(out)
    if manifest is None:
        raise ValueError(
            f"artifact {out} has no integrity manifest (export did not "
            f"complete) — re-export it"
        )
    errors = mf.verify_step_dir(out, manifest)
    if errors:
        raise ValueError(
            f"artifact {out} failed integrity verification: "
            + "; ".join(errors[:5])
        )
    with np.load(os.path.join(out, PARAMS_NPZ), allow_pickle=False) as npz:
        leaves = {tuple(name.split("/")): npz[name] for name in npz.files}
    params = unflatten_tree({path: leaf for path, leaf in leaves.items()
                             if path[0] != _STATS_PREFIX})
    batch_stats = unflatten_tree({path[1:]: leaf
                                  for path, leaf in leaves.items()
                                  if path[0] == _STATS_PREFIX})
    digest = param_tree_digest(params)
    if digest != meta["param_spec_digest"]:
        raise ValueError(
            f"artifact {out} param tree digest mismatch: recorded "
            f"{meta['param_spec_digest'][:12]}…, loaded {digest[:12]}… — "
            f"the stored tree does not match what was exported"
        )
    return Artifact(
        model_config=_build(ModelConfig, meta["model"]),
        task=meta["task"],
        state_dict=flax_to_state_dict(params, batch_stats),
        step=int(meta["step"]),
        param_spec_digest=digest,
        input_spec=meta["input_spec"],
        meta=meta,
        content_digest=artifact_content_digest(manifest),
    )
