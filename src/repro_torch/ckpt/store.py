"""Sharded checkpoint store: npz shards + JSON manifest + SHA256 integrity
(the port of ``repro/ckpt/store.py``, over the port's flat
``{name: tensor}`` state).

Layout of one checkpoint:

    <root>/step_<N>/
        manifest.json         # leaf names, shapes, dtypes, shard map, hashes
        shard_<i>.npz         # leaf arrays (split by shard)
        COMMITTED             # atomic commit marker (written last)

Writes go to ``step_<N>.tmp`` and are renamed after the COMMITTED marker is
in place, so a crash mid-save never corrupts the latest checkpoint.  Every
file inside the tmp dir is itself written atomically (``.part`` + fsync +
``os.replace``) and the marker goes last, so a torn write can never pass
for a committed image: a truncated shard fails the load (bad zip or
integrity hash) and the restore path falls through to the next replica.
``n_shards`` emulates per-host sharding: leaves are assigned greedily by
size to shards, and the shards are hashed, written and read back each on
a thread of its own (hashing, the zip CRC and the file I/O let go of the
GIL), so an image of many GB moves at several cores' rate.

numpy has no bfloat16: such a leaf is stored as its 16-bit pattern
(``uint16``) and the manifest records ``bfloat16``, so a round trip is
bitwise.  Leaves are given as tensors (on any device) or numpy arrays and
come back as tensors on the device and in the dtype of ``like``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Mapping[str, Any]

_MANIFEST = "manifest.json"
_COMMITTED = "COMMITTED"
_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def to_numpy(x: Any) -> np.ndarray:
    """A host numpy array of a tensor or array (bfloat16 -> its uint16 bit
    pattern).  Shares memory with a CPU tensor; callers that need a
    snapshot copy first."""
    if torch.is_tensor(x):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _dtype_name(x: Any) -> str:
    if torch.is_tensor(x):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _hash(arr: np.ndarray) -> str:
    """The first 16 hex digits of the SHA256 of the array's C-order bytes
    (hashed in place, without a copy)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()[:16]


def _on_threads(fn, items: List[Any]) -> List[Any]:
    """``[fn(x) for x in items]``, each call on a thread of its own."""
    with ThreadPoolExecutor(max_workers=max(len(items), 1)) as pool:
        return list(pool.map(fn, items))


def _atomic_write(path: str, writer) -> None:
    """Write a file via ``.part`` + fsync + rename so it is all-or-nothing.

    ``writer(fileobj)`` produces the content.  A crash before the
    ``os.replace`` leaves only a ``.part`` file that every reader ignores;
    a crash after it leaves the complete, durable file.
    """
    part = path + ".part"
    with open(part, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(part, path)


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (durability of the rename itself)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open support
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - filesystems that reject dir fsync
        pass
    finally:
        os.close(fd)


def save_pytree(root: str, step: int, tree: Tree, n_shards: int = 4) -> str:
    """Atomically save a ``{name: tensor or array}`` checkpoint.  Returns the
    final directory."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves = [(name, to_numpy(x), _dtype_name(x)) for name, x in tree.items()]
    # Greedy size-balanced shard assignment (stable order for determinism).
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i][1].nbytes)
    shard_of: Dict[str, int] = {}
    loads = [0] * max(n_shards, 1)
    for i in order:
        s = int(np.argmin(loads))
        shard_of[leaves[i][0]] = s
        loads[s] += leaves[i][1].nbytes

    shards: Dict[int, Dict[str, np.ndarray]] = {}
    key_of: Dict[str, str] = {}
    for name, arr, _ in leaves:
        s = shard_of[name]
        key_of[name] = f"a{len(shards.setdefault(s, {}))}"
        shards[s][key_of[name]] = arr

    def write_shard(s: int) -> Dict[str, str]:
        arrs = shards[s]
        digests = {key: _hash(arr) for key, arr in arrs.items()}
        _atomic_write(os.path.join(tmp, f"shard_{s}.npz"),
                      lambda f: np.savez(f, **arrs))
        return digests

    digests = dict(zip(shards, _on_threads(write_shard, list(shards))))
    manifest: Dict[str, Any] = {"step": step, "n_shards": n_shards, "leaves": {}}
    for name, arr, dtype in leaves:
        s, key = shard_of[name], key_of[name]
        manifest["leaves"][name] = {
            "shard": s, "key": key, "shape": list(arr.shape),
            "dtype": dtype, "sha256_16": digests[s][key],
        }
    _atomic_write(os.path.join(tmp, _MANIFEST),
                  lambda f: f.write(json.dumps(manifest).encode()))
    # The marker is written (and fsynced) last: its presence certifies that
    # every shard above it is complete on disk.
    _atomic_write(os.path.join(tmp, _COMMITTED), lambda f: f.write(b"ok"))
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(root)
    return final


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, _COMMITTED))


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype in _TORCH_DTYPES:
        return torch.from_numpy(arr.view(np.int16)).view(_TORCH_DTYPES[dtype])
    return torch.from_numpy(arr)


def load_pytree(path: str, like: Tree, *, verify: bool = True
                ) -> Dict[str, torch.Tensor]:
    """Load a checkpoint into the names of ``like`` (shapes and dtypes
    validated); each leaf comes back as a tensor on its ``like`` leaf's
    device (CPU for a numpy leaf)."""
    if not is_committed(path):
        raise FileNotFoundError(f"checkpoint at {path} is not committed")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    metas = {}
    for name, leaf in like.items():
        if name not in manifest["leaves"]:
            raise KeyError(f"leaf {name!r} missing from checkpoint {path}")
        meta = metas[name] = manifest["leaves"][name]
        if tuple(meta["shape"]) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {name!r}: checkpoint shape {tuple(meta['shape'])} != "
                f"expected {tuple(leaf.shape)}")
        if meta["dtype"] != _dtype_name(leaf):
            raise ValueError(f"leaf {name!r}: checkpoint dtype "
                             f"{meta['dtype']} != expected {_dtype_name(leaf)}")
    keys: Dict[int, List[str]] = {}
    for meta in metas.values():
        keys.setdefault(meta["shard"], []).append(meta["key"])

    def read_shard(s: int) -> Dict[str, Tuple[np.ndarray, Optional[str]]]:
        """The shard's wanted arrays, each with its hash when verifying."""
        with np.load(os.path.join(path, f"shard_{s}.npz")) as z:
            return {key: (arr, _hash(arr) if verify else None)
                    for key in keys[s] for arr in (z[key],)}

    read = dict(zip(keys, _on_threads(read_shard, list(keys))))
    out = {}
    for name, leaf in like.items():
        meta = metas[name]
        arr, digest = read[meta["shard"]][meta["key"]]
        if list(arr.shape) != meta["shape"]:
            raise ValueError(f"leaf {name!r}: manifest/shard mismatch")
        if verify and digest != meta["sha256_16"]:
            raise IOError(f"leaf {name!r}: integrity hash mismatch (corrupt shard)")
        t = _to_tensor(arr, meta["dtype"])
        out[name] = t.to(leaf.device) if torch.is_tensor(leaf) else t
    return out


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """Committed checkpoints under root, sorted by step ascending."""
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            p = os.path.join(root, d)
            if is_committed(p):
                try:
                    out.append((int(d[5:]), p))
                except ValueError:
                    continue
    return sorted(out)


def latest_checkpoint(root: str) -> Optional[Tuple[int, str]]:
    cks = list_checkpoints(root)
    return cks[-1] if cks else None
