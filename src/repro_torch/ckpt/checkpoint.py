"""Atomic, integrity-checked checkpoints of parameter trees (npz arrays +
a JSON manifest): the port of ``repro/ckpt/checkpoint.py``, whose
manifest is msgpack; the port writes it as JSON so it needs no package
beyond NumPy.

Fault-tolerance contract:
  * writes go to a temporary directory that ``os.replace`` renames to
    ``<dir>/step_<step>`` — a crash mid-write never corrupts the latest
    checkpoint, and an existing checkpoint is never overwritten;
  * every array is sha256-hashed into the manifest; restore verifies
    before returning, so a torn or bit-rotted file fails loudly;
  * ``latest_step`` finds the newest *complete* checkpoint;
  * the SL ring handoff reuses the same machinery (``save_handoff``):
    the segment-A weights a satellite ships over the ISL *are* a
    checkpoint, so a satellite lost mid-pass degrades to "the next
    satellite restores the last handoff".
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.treeutil import (tree_bytes, tree_flatten_with_names,
                                       tree_unflatten)

_CKPT_RE = re.compile(r"^step_(\d+)$")
MANIFEST = "manifest.json"


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {name: leaf.detach().cpu().numpy()
            for name, leaf in tree_flatten_with_names(tree)}


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _manifest(flat: Dict[str, np.ndarray], meta: Optional[Dict]) -> str:
    entries = {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                   "sha256": _sha256(v)} for k, v in flat.items()}
    return json.dumps({"arrays": entries, "meta": meta or {}})


def save(directory: str, step: int, tree, meta: Optional[Dict] = None) -> str:
    """Atomically write checkpoint ``<directory>/step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".tmp.{step}.", dir=directory)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            f.write(_manifest(flat, meta))
        if os.path.isdir(final):
            # never overwrite silently; keep the existing complete ckpt
            shutil.rmtree(tmp)
            return final
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _load_verified(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    for k, info in manifest["arrays"].items():
        if k not in flat:
            raise IOError(f"checkpoint {path}: missing array {k}")
        if _sha256(flat[k]) != info["sha256"]:
            raise IOError(f"checkpoint {path}: integrity failure on {k}")
    return flat, manifest.get("meta", {})


def restore(directory: str, step: int, like) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a tree of tensors); each
    leaf comes back with the dtype and device of its ``like`` leaf."""
    path = os.path.join(directory, f"step_{step}")
    flat, meta = _load_verified(path)
    out = []
    for name, leaf in tree_flatten_with_names(like):
        if name not in flat:
            raise IOError(f"checkpoint {path}: missing {name}")
        arr = flat[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise IOError(f"{name}: shape {arr.shape} != {tuple(leaf.shape)}")
        out.append(torch.from_numpy(arr).to(device=leaf.device,
                                            dtype=leaf.dtype))
    return tree_unflatten(like, out), meta


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for entry in os.listdir(directory):
        m = _CKPT_RE.match(entry)
        if m and os.path.exists(os.path.join(directory, entry, MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


# --------------------------------------------------------------------------
# SL ring handoff = checkpoint of the satellite segment.
# --------------------------------------------------------------------------

def save_handoff(directory: str, pass_idx: int, segment_tree,
                 meta: Optional[Dict] = None) -> Tuple[str, int]:
    """Persist the segment-A weights shipped over the ISL; returns
    (path, payload_bytes) — the bytes are exactly the paper's D_ISL."""
    payload = tree_bytes(segment_tree)
    path = save(directory, pass_idx, segment_tree,
                meta=dict(meta or {}, payload_bytes=payload))
    return path, payload


def restore_handoff(directory: str, like, pass_idx: Optional[int] = None
                    ) -> Tuple[Any, Dict, int]:
    """Restore the most recent (or given) handoff; returns
    (tree, meta, pass_idx). Raises FileNotFoundError if none exists."""
    step = pass_idx if pass_idx is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no handoff in {directory}")
    tree, meta = restore(directory, step, like)
    return tree, meta, step
