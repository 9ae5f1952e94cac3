"""Integrity manifests: the commit/verify record of a saved directory.

The port's copy of ``ckpt/manifest.py``, byte-compatible with it (same
file name, schema and record layout):

  * ``write_manifest(dir, step, extra)`` hashes every payload file (sha256
    + byte size) and commits ``manifest.json`` via write-to-tmp + fsync +
    atomic rename — the manifest IS the commit record; ``extra`` adds
    commit-record fields (the data-state record, data/shard.py);
  * ``verify_step_dir`` re-hashes and reports every missing, truncated or
    mutated file;
  * ``quarantine`` renames a corrupt or uncommitted step directory to
    ``<step>.corrupt`` (``.N`` on a collision), so step listings
    (``step_dirs``, ``committed_steps``) never see it again while the
    evidence stays on disk.

Serving artifacts (serve/export.py) carry the same manifest. Stdlib only.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = "dtf-ckpt-manifest/1"
CORRUPT_SUFFIX = ".corrupt"
_HASH_CHUNK = 1 << 20


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def iter_payload_files(step_dir: str):
    """Relative paths of every payload file under a directory (the
    manifest itself and quarantine records are not payload)."""
    for root, _dirs, files in os.walk(step_dir):
        for name in sorted(files):
            rel = os.path.relpath(os.path.join(root, name), step_dir)
            if rel in (MANIFEST_NAME, "quarantine.json"):
                continue
            yield rel


def build_manifest(step_dir: str, step: int,
                   extra: dict | None = None) -> dict:
    """``extra`` merges additional commit-record fields without touching
    the reserved keys."""
    files = {}
    for rel in iter_payload_files(step_dir):
        path = os.path.join(step_dir, rel)
        files[rel] = {
            "sha256": file_sha256(path),
            "bytes": os.path.getsize(path),
        }
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "step": int(step),
        "created_t": time.time(),
        "file_count": len(files),
        "files": files,
    }
    for key, value in (extra or {}).items():
        if key in manifest:
            raise ValueError(f"extra manifest field {key!r} is reserved")
        manifest[key] = value
    return manifest


def write_manifest(step_dir: str, step: int,
                   extra: dict | None = None) -> str:
    """Hash the directory and atomically commit its manifest.

    tmp + fsync + rename, then fsync the directory so the rename itself is
    durable (a kill before the rename leaves NO manifest → the directory
    reads as uncommitted, never as half-committed).
    """
    manifest = build_manifest(step_dir, step, extra)
    path = os.path.join(step_dir, MANIFEST_NAME)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(step_dir, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    return path


def read_manifest(step_dir: str) -> dict | None:
    """The manifest, or None when absent/unreadable (uncommitted)."""
    try:
        with open(os.path.join(step_dir, MANIFEST_NAME)) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if manifest.get("schema") != MANIFEST_SCHEMA:
        return None
    return manifest


def verify_step_dir(step_dir: str, manifest: dict | None = None) -> list[str]:
    """Integrity errors for one directory ([] = verified).

    Detects missing files, size changes (truncation) and content mutation
    (hash mismatch). Extra files are tolerated.
    """
    manifest = manifest if manifest is not None else read_manifest(step_dir)
    if manifest is None:
        return ["no committed manifest (save did not complete)"]
    errors: list[str] = []
    for rel, meta in manifest.get("files", {}).items():
        path = os.path.join(step_dir, rel)
        if not os.path.isfile(path):
            errors.append(f"missing file {rel}")
            continue
        size = os.path.getsize(path)
        if size != meta.get("bytes"):
            errors.append(
                f"truncated/resized file {rel}: {size} bytes, "
                f"manifest says {meta.get('bytes')}"
            )
            continue
        if file_sha256(path) != meta.get("sha256"):
            errors.append(f"content hash mismatch for {rel}")
    return errors


def quarantine(root: str, step: int, reason: str,
               errors: list[str] | None = None) -> str | None:
    """Rename ``<root>/<step>`` to ``<root>/<step>.corrupt`` (suffixing
    ``.N`` if a previous quarantine of the same step exists) and drop a
    ``quarantine.json`` record inside. Returns the new path, or None when
    the step directory has already vanished."""
    src = os.path.join(root, str(step))
    if not os.path.isdir(src):
        return None
    dst = src + CORRUPT_SUFFIX
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}{CORRUPT_SUFFIX}.{n}"
    os.replace(src, dst)
    record = {"step": int(step), "reason": reason,
              "errors": list(errors or []), "t": time.time(),
              "pid": os.getpid()}
    try:
        with open(os.path.join(dst, "quarantine.json"), "w") as fh:
            json.dump(record, fh, indent=1)
    except OSError:  # the rename already did the real work
        pass
    log.warning("quarantined checkpoint step %d -> %s (%s)", step, dst, reason)
    return dst


def step_dirs(root: str) -> dict[int, str]:
    """step -> path for every non-quarantined step directory."""
    out: dict[int, str] = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if name.isdigit() and os.path.isdir(os.path.join(root, name)):
            out[int(name)] = os.path.join(root, name)
    return out


def committed_steps(root: str) -> list[int]:
    """Steps whose directory carries a committed manifest, ascending."""
    return sorted(step for step, path in step_dirs(root).items()
                  if read_manifest(path) is not None)


def latest_committed_step(root: str) -> int | None:
    """Newest committed step, or None."""
    steps = committed_steps(root)
    return steps[-1] if steps else None
