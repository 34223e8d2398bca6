"""Fault-tolerant checkpointing (the port of the JAX package's
``train/checkpoint.py``), on the same on-disk format, so that each
package restores the other's checkpoints (docs/port.md §examples):

* ``step_XXXXXXXX/arrays.npz`` holds the leaves as ``a0``, ``a1``, … in
  flatten order, and ``manifest.json`` the ``step``, the ``extra`` dict
  and, per leaf, its ``shape``, ``dtype`` and ``crc32``; a bf16 leaf is
  stored as ``uint16`` and tagged ``"bfloat16"``;
* topology-agnostic: leaves are saved whole, on the host;
* atomic: writes go to ``step_XXXXXXXX.tmp/``, then ``os.replace`` to the
  final name; readers never observe a partial checkpoint;
* validated: every leaf records a crc32; a restore skips a corrupt
  checkpoint for the newest valid one and refuses a shape or dtype
  mismatch;
* async: :class:`AsyncCheckpointer` copies every leaf to host memory
  before its writer thread starts.

The manifest records no paths, so the leaf order is the whole contract.
:func:`tree_flatten` walks nested dicts, lists and tuples as
``jax.tree_util.tree_flatten`` does: a dict's keys in sorted order (an
``OrderedDict``'s in insertion order), lists and tuples by index, ``None``
as an empty subtree; anything else is a leaf. An ``interop.Stacked`` leaf
(a model's per-layer tensors standing for one stacked leaf of the
reference's parameter tree) is saved stacked, and restores as one stacked
tensor (docs/port.md §train).
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.interop import Stacked

_STEP_RE = re.compile(r"^step_(\d{8})$")

# --------------------------------------------------------------------------
# Trees
# --------------------------------------------------------------------------


def _children(tree):
    """``(children, rebuild)`` of a container node, or ``None`` for a
    leaf."""
    if tree is None:
        return [], lambda _: None
    if isinstance(tree, collections.OrderedDict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda c: type(tree)(zip(keys, c))
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda c: type(tree)(zip(keys, c))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # namedtuple
        return list(tree), lambda c: type(tree)(*c)
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda c: type(tree)(c)
    return None


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """The leaves of ``tree`` in the reference's order, and the structure
    :func:`tree_unflatten` rebuilds from."""
    node = _children(tree)
    if node is None:
        return [tree], None
    children, rebuild = node
    leaves, defs = [], []
    for child in children:
        sub, d = tree_flatten(child)
        leaves += sub
        defs.append((len(sub), d))
    return leaves, (rebuild, defs)


def tree_unflatten(treedef, leaves: list) -> Any:
    if treedef is None:
        (leaf,) = leaves
        return leaf
    rebuild, defs = treedef
    out, i = [], 0
    for n, d in defs:
        out.append(tree_unflatten(d, leaves[i:i + n]))
        i += n
    return rebuild(out)


def tree_map(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


# --------------------------------------------------------------------------
# Leaves
# --------------------------------------------------------------------------


def _dtype_tag(dtype) -> str:
    """The manifest's dtype name of a torch or numpy dtype (``float32``,
    ``bfloat16``, ``int32``, …; the names numpy and the reference use)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


class _Host:
    """A host copy of one leaf, which the caller may then overwrite: its
    stored array and its dtype tag. The leaf is a tensor (a CUDA one
    waits for the work that produces it on the current stream, nothing
    else), an array or a scalar; bf16 is stored as its uint16 bits."""

    __slots__ = ("array", "dtype")

    def __init__(self, leaf):
        if isinstance(leaf, _Host):
            self.array, self.dtype = leaf.array, leaf.dtype
            return
        if isinstance(leaf, Stacked):  # stored stacked, as the reference's
            parts = [_Host(p) for p in leaf.parts]
            self.array = np.stack([p.array for p in parts])
            self.dtype = parts[0].dtype
            return
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            arr = t.numpy()
        else:
            arr = np.array(leaf)
        self.dtype = (_dtype_tag(leaf.dtype) if isinstance(leaf, torch.Tensor)
                      else str(arr.dtype))
        self.array = arr.view(np.uint16) if self.dtype == "bfloat16" else arr


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


# --------------------------------------------------------------------------
# Save
# --------------------------------------------------------------------------


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Synchronous atomic checkpoint write. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, _ = tree_flatten(tree)
    manifest = {"step": step, "extra": extra or {}, "arrays": []}
    arrays = {}
    for i, leaf in enumerate(leaves):
        host = _Host(leaf)
        key = f"a{i}"
        arrays[key] = host.array
        manifest["arrays"].append({
            "key": key,
            "shape": list(host.array.shape),
            "dtype": host.dtype,
            "crc32": _crc(host.array),
        })
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot synchronously, write in the background, one in flight.

    :meth:`save` copies every leaf to host memory before the writer
    thread starts, so a launch issued after it returns may overwrite the
    saved tensors in place. Each CUDA copy waits only for the work that
    produces its tensor on the current stream; the card is never
    synchronized as a whole."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()
        host_tree = tree_map(_Host, tree)

        def _work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


# --------------------------------------------------------------------------
# Restore
# --------------------------------------------------------------------------


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _validate_and_load(path: str) -> tuple[dict, list] | None:
    """The manifest and ``(array, dtype tag)`` per leaf, or ``None`` when a
    file is missing or unreadable, a crc differs or a shape disagrees."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            leaves = []
            for rec in manifest["arrays"]:
                arr = z[rec["key"]]
                if _crc(arr) != rec["crc32"]:
                    return None
                if list(arr.shape) != rec["shape"]:
                    return None
                leaves.append((arr, rec["dtype"]))
        return manifest, leaves
    except Exception:
        return None


def _to_tensor(arr: np.ndarray, tag: str, like) -> torch.Tensor:
    """A stored leaf as a tensor on ``like``'s device (the CPU for a meta
    tensor)."""
    arr = np.array(arr, order="C")  # a writable copy; keeps 0-d leaves 0-d
    if tag == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    dev = like.device if isinstance(like, (torch.Tensor, Stacked)) else "cpu"
    dev = "cpu" if torch.device(dev).type == "meta" else dev
    return t.to(dev)


def restore_latest(ckpt_dir: str, like: Any) -> tuple[int, Any, dict] | None:
    """Restore the newest *valid* checkpoint into the structure of ``like``
    (a tree of tensors, meta tensors included, or numpy arrays). Each leaf
    comes back as a tensor on its ``like`` leaf's device (the CPU for a
    meta or numpy leaf) and in its dtype. Corrupt checkpoints, and ones
    whose leaves differ from ``like``'s in number, shape or dtype, are
    skipped. Returns ``(step, tree, extra)`` or ``None``."""
    likes, treedef = tree_flatten(like)
    want = [(tuple(x.shape), _dtype_tag(x.dtype)) for x in likes]
    for step in reversed(available_steps(ckpt_dir)):
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        got = _validate_and_load(path)
        if got is None:
            continue
        manifest, leaves = got
        if len(leaves) != len(want):
            continue
        if not all(tuple(a.shape) == s and tag == d
                   for (a, tag), (s, d) in zip(leaves, want)):
            continue
        tensors = [_to_tensor(a, tag, x)
                   for (a, tag), x in zip(leaves, likes)]
        return step, tree_unflatten(treedef, tensors), manifest.get(
            "extra", {})
    return None


def corrupt_for_test(ckpt_dir: str, step: int) -> None:
    """Deliberately flip bytes in a checkpoint (failure-injection tests).

    Spray 16-byte garbage every 256 bytes so at least one stored array
    payload is hit regardless of zip layout."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        for off in range(128, max(size - 32, 129), 256):
            f.seek(off)
            f.write(b"\xde\xad\xbe\xef" * 4)
