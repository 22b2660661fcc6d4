"""npz-based parameter-tree checkpointing (counterpart of
``repro.checkpoint.checkpointer``).

Leaves are keyed by their tree path, joined with ``/`` (dict key, list
index: ``layers/0/b``), in ``repro_torch.tree.leaves`` order, which is
``jax.tree.flatten``'s.  The keys are the reference's ``_key`` strings, so
a file written by either package reads in the other.

Two layers:

``save_checkpoint``/``load_checkpoint`` — a single ``.npz``/``.json``
pair; not crash-safe.

``save_snapshot``/``load_snapshot``/``restore_tree`` — the crash-safe
serving snapshot.  Each save writes a ``.npz``/``.json`` pair into the
OLDER of two slots (``<base>.a.*`` / ``<base>.b.*``) through temp files,
fsync and atomic renames, never touching the newer slot, so a writer
killed at any instant leaves at most one torn slot.  The loader validates
the json, the npz, and a random nonce stored in both halves, and falls
back to the other slot.  Every leaf's dtype name is recorded in the json
half.

numpy has no bfloat16 and the port imports no ``ml_dtypes``: a
``torch.bfloat16`` leaf is written as its ``uint16`` bit pattern and
recorded as ``"bfloat16"``.  Reading, a leaf recorded as bfloat16 (the
reference writes it as void ``|V2`` bytes) comes back as its ``uint16``
bit pattern, and ``restore_tree`` views it as ``torch.bfloat16`` where the
template leaf is bf16.
"""

from __future__ import annotations

import json
import os
import pathlib
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten_like
from repro_torch.weights import BF16, tensor_from_numpy, tensor_to_numpy

_NONCE_KEY = "__nonce__"
_SLOTS = (".a", ".b")


def _paths(tree: Any, prefix: Tuple = ()) -> List[Tuple]:
    """Every leaf's path, in ``leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                         prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, item in enumerate(tree)
                for p in _paths(item, prefix + (i,))]
    return [prefix]


def _key(path: Tuple) -> str:
    return "/".join(str(e) for e in path)


def keyed_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs in ``leaves`` order."""
    return [(_key(p), x) for p, x in zip(_paths(tree), leaves(tree))]


def _host(x) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and its dtype name."""
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    a = np.asarray(x)
    return a, a.dtype.name


def flatten_to_numpy(tree: Any, prefix: str = "") -> Tuple[
        Dict[str, np.ndarray], Dict[str, str]]:
    """(arrays by ``prefix + key``, dtype names by the same keys)."""
    arrays, names = {}, {}
    for k, x in keyed_leaves(tree):
        arrays[prefix + k], names[prefix + k] = _host(x)
    return arrays, names


def save_checkpoint(path: str, tree: Any, *, step: int = 0,
                    metadata: dict | None = None):
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays, _ = flatten_to_numpy(tree)
    np.savez(path.with_suffix(".npz"), **arrays)
    meta = {"step": step, **(metadata or {})}
    path.with_suffix(".json").write_text(json.dumps(meta))
    return str(path.with_suffix(".npz"))


def load_checkpoint(path: str, like: Any):
    """Restore into the structure of ``like`` (a template tree), onto each
    template leaf's device and dtype (``restore_tree``)."""
    path = pathlib.Path(path)
    with np.load(path.with_suffix(".npz")) as data:
        arrays = {k: data[k] for k in data.files}
    restored = restore_tree(arrays, like)
    meta = {}
    if path.with_suffix(".json").exists():
        meta = json.loads(path.with_suffix(".json").read_text())
    return restored, meta


# ---------------------------------------------------------------------------
# crash-safe serving snapshots (two-slot, torn-write tolerant, dtype-exact)
# ---------------------------------------------------------------------------

def _as_dtype(arr: np.ndarray, name: str) -> np.ndarray:
    """The array as its recorded dtype; bfloat16 as its ``uint16`` bit
    pattern."""
    if name == BF16:
        return arr.view(np.uint16) if arr.dtype.itemsize == 2 else arr
    dt = np.dtype(name)
    return arr.view(dt) if arr.dtype.itemsize == dt.itemsize else \
        arr.astype(dt)


def _slot_paths(base, slot: str) -> Tuple[pathlib.Path, pathlib.Path]:
    s = str(base) + slot
    return pathlib.Path(s + ".npz"), pathlib.Path(s + ".json")


def _read_slot(base, slot: str) -> Optional[Tuple[dict, dict]]:
    """Validate one slot end to end; None on any defect (missing half,
    unparseable json, truncated npz, nonce mismatch between halves)."""
    npz_p, json_p = _slot_paths(base, slot)
    if not (npz_p.exists() and json_p.exists()):
        return None
    try:
        meta = json.loads(json_p.read_text())
        nonce = meta["nonce"]
        with np.load(npz_p) as data:
            if _NONCE_KEY not in data.files:
                return None
            if bytes(data[_NONCE_KEY]).hex() != nonce:
                return None
            arrays = {k: data[k] for k in data.files if k != _NONCE_KEY}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        # what a torn write leaves behind: an unreadable file, unparseable
        # json (ValueError covers JSONDecodeError), a missing meta key, a
        # truncated or corrupt npz archive
        return None
    dtypes = meta.get("dtypes", {})
    for k, arr in arrays.items():
        name = dtypes.get(k)
        if name and arr.dtype.name != name:
            arrays[k] = _as_dtype(arr, name)
    return arrays, meta


def _fsync_write(path: pathlib.Path, writer) -> None:
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def save_snapshot(path: str, tree: Any, *, step: int = 0,
                  metadata: dict | None = None) -> str:
    """Write one snapshot generation crash-safely and return the npz path.

    ``tree`` is a tree, or a flat ``{key: leaf}`` dict whose keys become
    the npz keys as they are.  The target slot is the stale one (invalid,
    absent, or lower step): the newest valid slot is never touched, so a
    kill mid-write costs at most this generation.  Within the slot: temp
    files, fsync, then two atomic renames (npz first; a kill between them
    leaves a nonce mismatch the loader rejects)."""
    base = pathlib.Path(path)
    base.parent.mkdir(parents=True, exist_ok=True)
    arrays, names = flatten_to_numpy(tree)
    if _NONCE_KEY in arrays:
        raise ValueError(f"reserved leaf key {_NONCE_KEY}")
    nonce = os.urandom(8).hex()
    meta = {"step": int(step), "nonce": nonce, "dtypes": names,
            **(metadata or {})}

    # the slot to overwrite: invalid/absent beats valid, lower step beats
    # higher
    def slot_step(slot: str) -> float:
        got = _read_slot(base, slot)
        return float(got[1].get("step", 0)) if got is not None else -np.inf
    target = min(_SLOTS, key=slot_step)

    npz_p, json_p = _slot_paths(base, target)
    tmp_npz = pathlib.Path(str(base) + target + ".tmp.npz")
    tmp_json = pathlib.Path(str(base) + target + ".tmp.json")
    _fsync_write(tmp_npz, lambda f: np.savez(
        f, **{_NONCE_KEY: np.frombuffer(bytes.fromhex(nonce), np.uint8)},
        **arrays))
    _fsync_write(tmp_json, lambda f: f.write(json.dumps(meta).encode()))
    os.replace(tmp_npz, npz_p)
    os.replace(tmp_json, json_p)
    return str(npz_p)


def load_snapshot(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Newest valid generation: (arrays by leaf key, in their recorded
    dtypes, bfloat16 as ``uint16`` bit patterns; meta).  Raises
    FileNotFoundError when no slot validates."""
    base = pathlib.Path(path)
    best = None
    for slot in _SLOTS:
        got = _read_slot(base, slot)
        if got is not None and (best is None
                                or got[1].get("step", 0)
                                > best[1].get("step", 0)):
            best = got
    if best is None:
        raise FileNotFoundError(f"no valid snapshot slot at {base}.{{a,b}}")
    return best


def restore_tree(arrays: Dict[str, np.ndarray], like: Any,
                 prefix: str = "") -> Any:
    """Rebuild a tree shaped like ``like`` from ``load_snapshot`` (or
    ``np.load``) arrays.  A tensor leaf comes back as a tensor on its
    template's device with its template's dtype (a bf16 template views the
    stored bit pattern; any other dtype mismatch raises); a numpy leaf as
    the array; a python/numpy scalar as a scalar of the template's type."""
    out = []
    for k, t in keyed_leaves(like):
        arr = arrays[prefix + k]
        if isinstance(t, torch.Tensor):
            x = tensor_from_numpy(arr, t.device,
                                  BF16 if t.dtype == torch.bfloat16 else None)
            if x.dtype != t.dtype or tuple(x.shape) != tuple(t.shape):
                raise ValueError(
                    f"leaf {prefix + k}: stored {tuple(x.shape)} {x.dtype}, "
                    f"template {tuple(t.shape)} {t.dtype}")
            out.append(x)
        elif isinstance(t, np.ndarray):
            out.append(arr)
        elif np.isscalar(t):
            out.append(type(t)(arr.item()))
        else:
            out.append(arr)
    return unflatten_like(like, out)
