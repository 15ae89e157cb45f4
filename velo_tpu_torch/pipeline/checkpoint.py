"""Checkpoint / resume of the odometry state
(port of ``velo_tpu/pipeline/checkpoint.py``).

The whole odometry state is one fixed-shape tuple of tensors
(``OdomCarry``), so crash recovery is one ``.npz`` dump: every tensor leaf
is saved under its path in the carry, and resume rebuilds the carry for the
same config and refills the leaves.  The file layout is the reference's
(``leaf_{i}``, ``__names__``, ``__frame_idx__``, ``__hist_{k}__``) and the
leaf names are the paths ``jax.tree_util.keystr`` gives the reference's
carry, in the same order, so a checkpoint written by either package loads
into the other.  ``frame_host``, the port's host-side copy of the frame
counter, is not a leaf: ``load_carry`` sets it from ``frame_idx``.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

_NOT_LEAVES = ("frame_host",)


def _flatten(tree: Any, prefix: str = ""):
    """[(path, tensor)] of a carry, depth first in field order: ``.name``
    for a NamedTuple field, ``[i]`` for a tuple element, nothing for
    None."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", None)
        out = []
        for i, item in enumerate(tree):
            if fields is not None and fields[i] in _NOT_LEAVES:
                continue
            key = f".{fields[i]}" if fields is not None else f"[{i}]"
            out.extend(_flatten(item, prefix + key))
        return out
    return [(prefix, tree)]


def _unflatten(template: Any, leaves: list):
    """``template`` with its leaves replaced, in :func:`_flatten` order
    (``leaves`` is consumed from the front)."""
    if template is None:
        return None
    if isinstance(template, tuple):
        fields = getattr(template, "_fields", None)
        items = []
        for i, item in enumerate(template):
            if fields is not None and fields[i] in _NOT_LEAVES:
                items.append(item)
            else:
                items.append(_unflatten(item, leaves))
        return type(template)(*items) if fields is not None else tuple(items)
    return leaves.pop(0)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_carry(path: str, carry: Any, frame_idx: int | None = None,
               history: dict[str, np.ndarray] | None = None) -> None:
    """Dump the carry (+ optional per-frame history arrays).

    ``history`` holds the trajectory and diagnostics accumulated so far, so
    that a resumed run can return the full sequence rather than just the
    tail after the checkpoint.  Written to ``path + ".tmp"`` and renamed,
    so a crash never leaves a half-written checkpoint under ``path``.
    """
    flat = _flatten(carry)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"leaf_{i}": _to_numpy(a) for i, (_, a) in enumerate(flat)}
    payload["__names__"] = np.asarray([name for name, _ in flat])
    if frame_idx is not None:
        payload["__frame_idx__"] = np.asarray(frame_idx)
    for k, v in (history or {}).items():
        payload[f"__hist_{k}__"] = np.asarray(v)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_carry(path: str, template: Any, device=None) -> Any:
    """Refill ``template`` (e.g. ``init_carry(cfg)``) from a checkpoint, on
    ``device`` (default: the template's).

    Shapes and structure must match, i.e. the same config, which is
    verified leaf by leaf.
    """
    flat = _flatten(template)
    with np.load(path, allow_pickle=False) as data:
        saved_names = [str(s) for s in data["__names__"]]
        if [name for name, _ in flat] != saved_names:
            raise ValueError(
                "checkpoint structure mismatch: was it written with a "
                f"different config? ({len(saved_names)} leaves vs "
                f"{len(flat)})")
        out = []
        for i, (name, leaf) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(
                    f"leaf {name}: shape {arr.shape} != {tuple(leaf.shape)}")
            out.append(torch.as_tensor(arr).to(
                device=leaf.device if device is None else device,
                dtype=leaf.dtype))
    carry = _unflatten(template, out)
    if hasattr(carry, "frame_host"):
        carry = carry._replace(frame_host=int(carry.frame_idx))
    return carry


def load_history(path: str) -> dict[str, np.ndarray]:
    """Per-frame history arrays stored alongside the carry (may be empty)."""
    with np.load(path, allow_pickle=False) as data:
        return {k[len("__hist_"):-2]: data[k] for k in data.files
                if k.startswith("__hist_") and k.endswith("__")}


def checkpoint_frame(path: str) -> int | None:
    """Frame index stored in a checkpoint, or None."""
    with np.load(path, allow_pickle=False) as data:
        if "__frame_idx__" in data:
            return int(data["__frame_idx__"])
    return None
