"""Checkpoint save and load, the counterpart of ``thunder_tpu/checkpoint.py``:
``save_checkpoint`` (:89), ``wait_for_checkpoints`` (:166) and
``load_checkpoint`` (:214).

Format (the port's own: the reference writes orbax, or an ``npz`` plus a
pickled JAX tree definition that only ``thunder_tpu`` can read). A
checkpoint is a directory holding two files:

- ``leaves.pt``: the state's array leaves, in flattening order
  (:func:`thunder_tpu_torch.optim.tree_leaves`: dict keys sorted, lists and
  tuples in order), as one list of CPU tensors written by ``torch.save``;
- ``tree.json``: the tree around them. A node is ``{"dict": {key: node}}``
  (string keys), ``{"list": [node, ...]}``, ``{"tuple": [...]}``,
  ``{"tensor": i}`` or ``{"ndarray": i}`` (leaf ``i`` of ``leaves.pt``, the
  latter given back as a numpy array), or ``{"value": v}`` for a JSON
  scalar (None, a bool, an int, a float or a string).

Both files are written into a temporary directory beside the destination,
which is renamed into place last: a save torn by a crash leaves the
temporary directory, never a checkpoint that loads. Re-saving a path swaps
the new directory in and then removes the old one.

Semantics, as the reference's: one writer per path (a save of a path being
written joins the writer first), joiners block until the write commits, a
failed save raises in every joiner, and at most four asynchronous saves are
in flight (the oldest are joined first), and the ``checkpoint_io`` fault
domain (``runtime.faults``) fires at the start of ``save_checkpoint``, as the
reference's hook (:107) does.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any

import numpy as np
import torch

from thunder_tpu_torch.runtime import faults as _faults

LEAVES = "leaves.pt"
TREE = "tree.json"
_MAX_INFLIGHT = 4


class _Save:
    """One save of one path: its writer thread (asynchronous saves) and
    its outcome, which every joiner waits for."""

    def __init__(self):
        self.done = threading.Event()
        self.error: BaseException | None = None

    def finish(self, error: BaseException | None = None) -> None:
        self.error = error
        self.done.set()

    def wait(self, path: str) -> None:
        self.done.wait()
        if self.error is not None:
            raise RuntimeError(f"checkpoint save to {path} failed: {self.error!r}") \
                from self.error


_inflight: dict[str, _Save] = {}
_inflight_lock = threading.Lock()


def _flatten(tree, leaves: list) -> dict:
    """The JSON node of ``tree``; its array leaves, copied to the host,
    appended to ``leaves``."""
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"checkpoint: dict keys must be strings, got {list(tree)[:4]}")
        return {"dict": {k: _flatten(tree[k], leaves) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"list" if isinstance(tree, list) else "tuple":
                [_flatten(t, leaves) for t in tree]}
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach().to("cpu", copy=True))
        return {"tensor": len(leaves) - 1}
    if isinstance(tree, (np.ndarray, np.generic)):
        leaves.append(torch.from_numpy(np.array(tree)))
        return {"ndarray": len(leaves) - 1}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"checkpoint: cannot save a leaf of type {type(tree).__name__}")


def _unflatten(node: dict, leaves: list):
    (kind, v), = node.items()
    if kind == "dict":
        return {k: _unflatten(n, leaves) for k, n in v.items()}
    if kind in ("list", "tuple"):
        items = [_unflatten(n, leaves) for n in v]
        return items if kind == "list" else tuple(items)
    if kind == "tensor":
        return leaves[v]
    if kind == "ndarray":
        return leaves[v].numpy()
    return v


def _write(path: str, spec: dict, leaves: list) -> None:
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-{uuid.uuid4().hex}")
    try:
        os.makedirs(tmp)
        torch.save(leaves, os.path.join(tmp, LEAVES))
        with open(os.path.join(tmp, TREE), "w") as f:
            json.dump(spec, f)
        old = None
        if os.path.exists(path):
            old = os.path.join(parent, f".{os.path.basename(path)}.old-{uuid.uuid4().hex}")
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _release(path: str, save: _Save) -> None:
    with _inflight_lock:
        if _inflight.get(path) is save:
            del _inflight[path]


def save_checkpoint(path: str, state: Any, *, asynchronous: bool = False) -> bool:
    """Save a tree of tensors, numpy arrays and JSON scalars (parameters,
    optimizer state, step counters) to the directory ``path``.

    ``asynchronous=True``: every tensor is copied to the host before this
    returns, so the caller may go on updating the state in place; the files
    are written by a background thread (:func:`wait_for_checkpoints` joins
    it, and so do a later save or a load of the same path).

    Returns ``True`` when the write goes on in the background, ``False``
    when the checkpoint is committed on return.

    The ``checkpoint_io`` fault domain (``runtime.faults``) fires here,
    before anything is written: a fault models the write failing before
    the checkpoint is committed."""
    _faults.maybe_fail("checkpoint_io", site=path)
    path = os.path.abspath(path)
    while True:
        wait_for_checkpoints(path)   # one writer per path: join the last one
        with _inflight_lock:
            if path in _inflight:
                continue   # another thread claimed the path: join it too
            save = _Save()
            _inflight[path] = save
            overflow = list(_inflight)[:-_MAX_INFLIGHT] if asynchronous else []
        break
    try:
        leaves: list = []
        spec = _flatten(state, leaves)
        if not asynchronous:
            _write(path, spec, leaves)
    except BaseException as e:
        save.finish(e)
        _release(path, save)
        raise
    if not asynchronous:
        save.finish()
        _release(path, save)
        return False

    def write():
        try:
            _write(path, spec, leaves)
        except BaseException as e:
            save.finish(e)   # reaches every joiner
            raise
        save.finish()

    try:
        for k in overflow:   # bound the backlog, joining outside the lock
            if k != path:
                wait_for_checkpoints(k)
    except BaseException as e:
        save.finish(e)
        _release(path, save)
        raise
    threading.Thread(target=write, name=f"checkpoint {path}").start()
    return True


def wait_for_checkpoints(path: str | None = None) -> None:
    """Block until asynchronous saves commit: all of them (``path=None``)
    or the one writing ``path``. Raises if a save it joins failed."""
    if path is None:
        with _inflight_lock:
            keys = list(_inflight)
    else:
        keys = [os.path.abspath(path)]
    for k in keys:
        with _inflight_lock:
            save = _inflight.get(k)
        if save is None:
            continue
        try:
            save.wait(k)   # wait first, unregister after: joiners meanwhile block too
        finally:
            _release(k, save)


def load_checkpoint(path: str, template: Any | None = None, device=None) -> Any:
    """Load a checkpoint (joining an asynchronous save of ``path`` first).

    Tensors come back on ``device`` (the CPU when None). With a
    ``template``, a tree of the same structure, each tensor must have its
    template leaf's shape and is cast to its dtype and, unless ``device`` is
    given, moved to its device."""
    path = os.path.abspath(path)
    wait_for_checkpoints(path)
    with open(os.path.join(path, TREE)) as f:
        spec = json.load(f)
    leaves = torch.load(os.path.join(path, LEAVES), weights_only=True)
    tree = _unflatten(spec, leaves)
    if template is None:
        return tree if device is None else _map_tensors(lambda t, _: t.to(device), tree, tree)
    return _map_tensors(lambda t, like: _as_template(t, like, device), tree, template)


def _map_tensors(fn, tree, like):
    if isinstance(tree, dict):
        if not isinstance(like, dict) or set(tree) != set(like):
            raise ValueError("load_checkpoint: the checkpoint's tree does not match the template")
        return {k: _map_tensors(fn, tree[k], like[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if not isinstance(like, (list, tuple)) or len(tree) != len(like):
            raise ValueError("load_checkpoint: the checkpoint's tree does not match the template")
        return type(tree)(_map_tensors(fn, t, lk) for t, lk in zip(tree, like))
    return fn(tree, like) if isinstance(tree, torch.Tensor) else tree


def _as_template(t: torch.Tensor, like, device) -> torch.Tensor:
    if not isinstance(like, torch.Tensor):
        return t if device is None else t.to(device)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"load_checkpoint: a leaf of shape {tuple(t.shape)} where the "
                         f"template has {tuple(like.shape)}")
    return t.to(device=device if device is not None else like.device, dtype=like.dtype)
