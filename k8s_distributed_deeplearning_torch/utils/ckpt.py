"""Checkpoint-directory integrity: manifests, quarantine, step scanning.

Own copy of ``k8s_distributed_deeplearning_tpu/utils/ckpt.py``, with the
same on-disk names, so the JAX package's control plane (its ``launch
watch`` progress probe, its fault injector) reads a directory the port
wrote unchanged:

- ``train/checkpoint.py`` writes a per-step manifest beside each committed
  step directory and verifies it before restore (the crash-safe restore
  chain);
- a control plane reads the latest on-disk step to measure progress
  between restarts, without loading any checkpoint.

The manifest is ``manifest-<step>.json`` NEXT TO the step directory (not
inside it: retention deletes whole step dirs, and manifests of vanished
steps are garbage-collected with :func:`gc_manifests`). It records every
file under the step dir with size and MD5. A checkpoint whose directory
was committed but whose bytes are torn (killed mid-write on a non-atomic
filesystem, truncated by a full disk, bit-flipped at rest) fails
verification and is quarantined: renamed to ``quarantined-<step>-<k>`` so
the evidence survives for post-mortem while the restore chain falls back
to the previous step.
"""
from __future__ import annotations

import hashlib
import json
import os

MANIFEST_PREFIX = "manifest-"
QUARANTINE_PREFIX = "quarantined-"


def steps_on_disk(directory: str) -> list[int]:
    """Committed checkpoint steps under *directory*, ascending (digit-named
    subdirectories; a step being written lives in ``<step>.tmp-<pid>``,
    which never parses as an int)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for n in names:
        if n.isdigit() and os.path.isdir(os.path.join(directory, n)):
            steps.append(int(n))
    return sorted(steps)


def latest_step_on_disk(directory: str) -> int | None:
    """Newest committed step, or None for an empty/missing directory. The
    control plane's progress probe: no checkpoint is loaded."""
    steps = steps_on_disk(directory)
    return steps[-1] if steps else None


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{MANIFEST_PREFIX}{step}.json")


def _file_md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(root: str) -> dict[str, str]:
    """relpath -> abspath for every regular file under *root*."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = p
    return out


def write_manifest(directory: str, step: int) -> dict:
    """Checksum every file of the committed step dir and write the manifest
    atomically (tmp + ``os.replace`` — a torn manifest must never read as a
    verdict on the checkpoint). Returns the manifest dict."""
    root = os.path.join(directory, str(step))
    files = {}
    for rel, p in sorted(_walk_files(root).items()):
        st = os.stat(p)
        files[rel] = {"size": st.st_size, "md5": _file_md5(p)}
    man = {"step": step, "files": files}
    path = manifest_path(directory, step)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(man, f)
    os.replace(tmp, path)
    return man


def gc_manifests(directory: str) -> None:
    """Drop manifests whose step dir is gone (retention deleted it)."""
    on_disk = set(steps_on_disk(directory))
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for n in names:
        if not (n.startswith(MANIFEST_PREFIX) and n.endswith(".json")):
            continue
        stem = n[len(MANIFEST_PREFIX):-len(".json")]
        if stem.isdigit() and int(stem) not in on_disk:
            try:
                os.remove(os.path.join(directory, n))
            except OSError:
                pass


def verify_manifest(directory: str, step: int) -> str | None:
    """Check the step dir against its manifest. Returns None when it
    verifies, else a one-line description of the first problem found.

    A MISSING manifest verifies as OK: checkpoints written before this
    scheme (or by a process killed between the commit and the manifest
    write: the step itself is complete, the rename is the commit point)
    are legitimate, and rejecting them would turn an upgrade
    into a mass quarantine."""
    mpath = manifest_path(directory, step)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return f"manifest unreadable: {e!r}"
    root = os.path.join(directory, str(step))
    present = _walk_files(root)
    for rel, meta in man.get("files", {}).items():
        p = present.get(rel)
        if p is None:
            return f"missing file {rel!r}"
        try:
            size = os.stat(p).st_size
        except OSError as e:
            return f"unreadable file {rel!r}: {e!r}"
        if size != meta["size"]:
            return (f"size mismatch on {rel!r}: {size} != manifest "
                    f"{meta['size']} (truncated?)")
        if _file_md5(p) != meta["md5"]:
            return f"checksum mismatch on {rel!r} (corrupt bytes)"
    return None


def quarantine_step(directory: str, step: int, reason: str) -> str:
    """Move a bad step out of the restore chain, keeping the evidence:
    ``<dir>/<step>`` → ``<dir>/quarantined-<step>-<k>`` (k picked to never
    clobber an earlier quarantine of the same step) with a ``reason.txt``
    dropped inside and the manifest moved alongside. Returns the new path.
    """
    src = os.path.join(directory, str(step))
    k = 0
    while True:
        dst = os.path.join(directory, f"{QUARANTINE_PREFIX}{step}-{k}")
        if not os.path.exists(dst):
            break
        k += 1
    os.replace(src, dst)
    mpath = manifest_path(directory, step)
    if os.path.exists(mpath):
        os.replace(mpath, os.path.join(dst, "manifest.json"))
    try:
        with open(os.path.join(dst, "reason.txt"), "w") as f:
            f.write(reason + "\n")
    except OSError:
        pass   # the rename is the quarantine; the note is best-effort
    return dst
