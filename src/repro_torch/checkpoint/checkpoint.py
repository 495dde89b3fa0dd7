"""Tree checkpoints (npz, path-keyed), and the reference's tree form.

Port of ``repro/checkpoint/checkpoint.py``.  A tree (dicts, lists and
tuples of tensors or arrays) is flattened into one array per leaf, keyed
by its path as the reference keys it: dict keys joined by ``/`` in
sorted order, ``#i`` for the i-th item of a list or tuple, so a file
written by either package loads in the other bit for bit.  The write
goes through a temporary file renamed over the target, so a killed run
never leaves a torn file.

The engine keeps its parameters as one flat dict of dotted names
(``encoder.0.w``, ``layers.mixer.wq``), the reference as a tree;
:func:`to_tree` and :func:`tree_get` map one onto the other (digits are
list indices), which is how snapshots and checkpoints take the
reference's form.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _part(name: str):
    return int(name) if name.isdigit() else name


def to_tree(flat: Mapping[str, Any], leaf: Callable[[Any], Any] = None):
    """Dotted names -> the nested tree (digits become list indices),
    each value through ``leaf`` (default: as it is)."""
    root: Dict[Any, Any] = {}
    for name, value in flat.items():
        node, path = root, [_part(p) for p in name.split(".")]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value if leaf is None else leaf(value)

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out
    return lists(root)


def tree_get(tree, name: str):
    """The leaf of ``tree`` at the dotted ``name``."""
    node = tree
    for p in name.split("."):
        node = node[_part(p)]
    return node


def host(x):
    """A tensor as a host numpy array of its own (never a view of the
    tensor's storage, which later rounds overwrite); anything else as it
    is."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.cpu() if x.device.type != "cpu" else x.clone()).numpy()
    return x


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        out: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (f"#{i}",)))
        return out
    if tree is None:
        return {}
    return {_SEP.join(prefix): np.asarray(host(tree))}


def _unflatten_into(template, flat: Mapping[str, np.ndarray],
                    prefix: Tuple[str, ...] = ()):
    if isinstance(template, Mapping):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, prefix + (f"#{i}",))
                              for i, v in enumerate(template))
    if template is None:
        return None
    key = _SEP.join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint shape mismatch at {key}: "
                         f"{arr.shape} vs template {tuple(template.shape)}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(template.device,
                                                  template.dtype)
    return arr.astype(np.asarray(template).dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    prefix: str = "ckpt") -> str:
    """Write ``tree`` as ``{prefix}_{step:08d}.npz`` in ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(ckpt_dir, f"{prefix}_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_step(ckpt_dir: str, *, prefix: str = "ckpt") -> Optional[int]:
    """The highest step checkpointed in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    pat = re.compile(rf"{re.escape(prefix)}_(\d+)\.npz$")
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := pat.match(f))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, template, step: Optional[int] = None, *,
                    prefix: str = "ckpt") -> Tuple[Any, int]:
    """``(tree, step)``: the checkpoint at ``step`` (default: the latest)
    in ``template``'s structure, each leaf a tensor on the template
    leaf's device and dtype (or an array of its dtype)."""
    if step is None:
        step = latest_step(ckpt_dir, prefix=prefix)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"{prefix}_{step:08d}.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(template, flat), step
