"""Checkpointing of trees of tensors and arrays (port of
``repro/checkpoint/ckpt.py``): flattened tree -> ``.npz`` + manifest.

A tree is nested dicts, lists, tuples and NamedTuples; every other value
is a leaf (a tensor, a numpy array or a scalar), and None is an empty
subtree. Leaves are gathered to the host before saving. The on-disk
format is the reference's, down to the manifest's path strings:

    <path>/arrays.npz       leaf i under key ``a{i}``
    <path>/manifest.json    {"paths", "step", "dtypes", "shapes"}

The paths are the strings ``jax.tree_util.tree_flatten_with_path`` gives,
joined by "/": ``['key']`` for a dict key (``[2]`` for an int key), ``[i]``
for a list or tuple element, ``.field`` for a NamedTuple field, with dict
keys in sorted order. So a directory written by either package restores
in the other. Saves are atomic (a temporary directory, then
``os.replace``), retention-pruned, and optionally asynchronous.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key-path entry, child) pairs of a container node, or None for a
    leaf; the entries print as jax's key-path entries do."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def _flatten_with_paths(tree: Any) -> tuple[list[str], list[Any]]:
    paths, leaves = [], []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for key, child in kids:
            walk(child, prefix + [key])

    walk(tree, [])
    return paths, leaves


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    values = [_unflatten(c, leaves) for _, c in kids]
    return type(like)(*values) if _is_namedtuple(like) else type(like)(values)


def to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (tensors leave the device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def host_tree(tree: Any, copy: bool = False) -> Any:
    """``tree`` with every leaf gathered to the host as numpy; ``copy``
    also copies leaves that already live on the host (a CPU tensor or an
    array the caller may write to later)."""
    _, leaves = _flatten_with_paths(tree)
    host = [to_host(l) for l in leaves]
    if copy:
        host = [np.array(a, copy=True) for a in host]
    return _unflatten(tree, iter(host))


def save_tree(path: str, tree: Any, step: int | None = None) -> None:
    paths, leaves = _flatten_with_paths(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(path) or ".")
    try:
        arrays = {f"a{i}": to_host(leaf) for i, leaf in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"paths": paths, "step": step,
                    "dtypes": [str(a.dtype) for a in arrays.values()],
                    "shapes": [list(a.shape) for a in arrays.values()]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)                       # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_tree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (validates paths match);
    the leaves come back as numpy arrays."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = _flatten_with_paths(like)
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint/model structure mismatch: "
            f"{set(paths) ^ set(manifest['paths'])}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        restored = [data[f"a{i}"] for i in range(len(leaves))]
    return _unflatten(like, iter(restored))


class CheckpointManager:
    """Retention + async saves + latest-step discovery."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                out.append(int(name[5:]))
        return sorted(out)

    def save(self, step: int, tree: Any) -> None:
        # gather to the host BEFORE handing off: the buffers may be
        # overwritten by the next step while the thread writes
        tree = host_tree(tree, copy=self.async_save)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, tree), daemon=True)
            self._thread.start()
        else:
            self._save_sync(step, tree)

    def _save_sync(self, step: int, tree: Any) -> None:
        save_tree(self._step_dir(step), tree, step)
        for old in self.steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore_latest(self, like: Any) -> tuple[int, Any] | None:
        self.wait()
        steps = self.steps()
        if not steps:
            return None
        return steps[-1], restore_tree(self._step_dir(steps[-1]), like)
