"""Fault-tolerant checkpointing.  Port of ``repro.checkpoint.manager``, in
the same on-disk format, so that each package restores the other's
checkpoints:

    <dir>/step_<n:08d>/arrays.npz + manifest.json {step, keys, checksum, time}

``arrays.npz`` holds one array per leaf of the saved tree (nested dicts of
tensors or arrays), keyed by the leaf's path joined with ``/`` as
``jax.tree_util.tree_flatten_with_path`` names it: ``params/embedding``,
``opt/acc/embedding``, adamw's ``opt/m/...``, ``opt/v/...`` and its int32
``opt/t``.  Shapes and dtypes are the tensors' own.

  * **atomic**   - written to ``step_<n>.tmp``, the manifest with the
                   file's sha256 last, then renamed.  A run killed
                   mid-write never corrupts the restore point; partial
                   directories are skipped on restore and removed when a
                   manager opens the directory.
  * **async**    - the device-to-host copy happens on the caller's thread;
                   serialization and disk IO on a writer thread.
  * **keep-k**   - bounded retention, with an optional "keep every Nth".

``restore`` takes ``device=`` (default cuda) where the JAX one takes
``shardings=``: the tensors come back on that one device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device

_CHUNK = 64 << 20


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree, path=()):
    """``[(path, leaf)]`` in the order of ``tree_flatten_with_path``: dict
    keys sorted, sequences by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten_with_paths(v, path + (i,))]
    return [(path, tree)]


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own: a CPU tensor's numpy view would
    follow the in-place updates of the steps after the save."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def save_pytree(tree, directory: str, step: int, timings: dict | None = None) -> str:
    """Atomic synchronous save.  Returns the final checkpoint dir.
    ``timings``, when given, receives the seconds of the write and of the
    checksum pass, and the file's bytes."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {_key(p): _host(leaf) for p, leaf in _flatten_with_paths(tree)}
    npz_path = os.path.join(tmp, "arrays.npz")
    t0 = time.perf_counter()
    np.savez(npz_path, **arrays)
    t1 = time.perf_counter()
    checksum = _sha256(npz_path)
    if timings is not None:
        timings.update(write_s=t1 - t0, checksum_s=time.perf_counter() - t1,
                       bytes=os.path.getsize(npz_path))
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "checksum": checksum,
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _valid_checkpoint(path: str) -> bool:
    man = os.path.join(path, "manifest.json")
    npz = os.path.join(path, "arrays.npz")
    if not (os.path.exists(man) and os.path.exists(npz)):
        return False
    try:
        with open(man) as f:
            manifest = json.load(f)
        return _sha256(npz) == manifest["checksum"]
    except Exception:
        return False


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    """``[(step, path)]`` of the valid checkpoints, oldest first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("step_") and not name.endswith(".tmp"):
            path = os.path.join(directory, name)
            if _valid_checkpoint(path):
                out.append((int(name.split("_")[1]), path))
    return sorted(out)


def restore_pytree(tree_like, directory: str, step: int | None = None, device=None):
    """Restore into the structure of ``tree_like`` (its leaves are ignored),
    each array as a tensor on ``device`` (default cuda).

    Returns (tree, step) or (None, None) when no valid checkpoint exists."""
    ckpts = list_checkpoints(directory)
    if not ckpts:
        return None, None
    if step is None:
        step, path = ckpts[-1]
    else:
        match = [c for c in ckpts if c[0] == step]
        if not match:
            return None, None
        step, path = match[0]
    dev = resolve_device(device)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def build(t, path=()):
            if isinstance(t, dict):
                return {k: build(v, path + (k,)) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(build(v, path + (i,)) for i, v in enumerate(t))
            return torch.from_numpy(np.array(data[_key(path)])).to(dev)

        tree = build(tree_like)
    return tree, step


class CheckpointManager:
    """Async keep-k checkpointing with crash-safe restore."""

    def __init__(self, directory: str, keep: int = 3, keep_every: int = 0):
        self.directory = directory
        self.keep = keep
        self.keep_every = keep_every
        self._thread: threading.Thread | None = None
        self.last_save: dict = {}     # seconds and bytes of the newest save
        os.makedirs(directory, exist_ok=True)
        self._gc_partial()

    def _gc_partial(self):
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def save(self, tree, step: int, blocking: bool = False):
        """Device-to-host copy now; serialization on the writer thread.
        ``last_save`` gets ``host_copy_s`` now and ``write_s``,
        ``checksum_s`` and ``bytes`` when the write ends."""
        t0 = time.perf_counter()
        host_tree = _host_tree(tree)   # sync point
        self.wait()
        timings = {"step": step, "host_copy_s": time.perf_counter() - t0}
        self.last_save = timings

        def work():
            save_pytree(host_tree, self.directory, step, timings)
            self._retention()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retention(self):
        ckpts = list_checkpoints(self.directory)
        keepers = set(s for s, _ in ckpts[-self.keep:])
        if self.keep_every:
            keepers |= {s for s, _ in ckpts if s % self.keep_every == 0}
        for s, path in ckpts:
            if s not in keepers:
                shutil.rmtree(path, ignore_errors=True)

    def restore(self, tree_like, step: int | None = None, device=None):
        return restore_pytree(tree_like, self.directory, step, device)

    def step_signature(self, step: int) -> tuple:
        """Cheap identity of the poll state: (step, checkpoint-directory
        mtime_ns, manifest mtime_ns).  Any save renames a directory into
        ``self.directory`` and so changes the signature: a poller can skip
        a corrupt newest step without missing a later landing."""
        def mtime(path):
            try:
                return os.stat(path).st_mtime_ns
            except OSError:
                return None

        man = os.path.join(self.directory, f"step_{step:08d}", "manifest.json")
        return (step, mtime(self.directory), mtime(man))

    def latest_step(self, validate: bool = True) -> int | None:
        """Newest checkpoint step.  ``validate=False`` discovers by
        directory name only (no checksum pass over every retained
        checkpoint): the cheap polling mode for serving loops, whose
        ``restore`` still validates what it loads."""
        if not validate:
            steps = [int(n.split("_")[1]) for n in
                     (os.listdir(self.directory) if os.path.isdir(self.directory) else [])
                     if n.startswith("step_") and not n.endswith(".tmp")]
            return max(steps, default=None)
        ckpts = list_checkpoints(self.directory)
        return ckpts[-1][0] if ckpts else None

    def step_valid(self, step: int) -> bool:
        """Full validation (manifest present, checksum matches) of one step."""
        return _valid_checkpoint(os.path.join(self.directory, f"step_{step:08d}"))


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _host(tree)
