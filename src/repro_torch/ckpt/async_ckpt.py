"""Asynchronous checkpoint writer with neighbour replication (the port of
``repro/ckpt/async_ckpt.py``).

The paper's V (checkpoint overhead) has two parts: capturing the state and
pushing it to reliable storage.  The training loop pays only for the
*blocking* part, a host snapshot of the state; serialization, fsync and
replication run on a background thread.  The measured blocking time is
reported to the adaptive controller as V.

The snapshot must copy.  The JAX package snapshots with ``np.asarray``,
safe because JAX arrays are immutable; the port's train step updates its
tensors in place, and on the CPU ``.cpu()``/``.numpy()`` share memory with
the live tensor, so the writer would save values that later steps have
changed.  :meth:`AsyncCheckpointer.save` copies every leaf to host memory
(``.to("cpu", copy=True)``) before it returns, and that copy is the V.

Replication: each checkpoint is copied to 'neighbour' stores (directories
standing in for other hosts' disks), the analogue of the paper's P2P
storage.  With ``replication_factor`` R, each step's image lands on the R
neighbours that win the highest-random-weight hash for that step
(:func:`repro_torch.p2p.overlay.rendezvous_placement`); ``None`` copies to
all.  Restore falls back through replicas when the primary is corrupt or
missing.

Retention (not in the reference, whose images are megabytes): with
``keep`` N, the writer drops this checkpointer's own images beyond its
newest N after each commit, everywhere it wrote them.  Images it did not
write (an earlier run's, in a reused directory) are left alone.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Collection, Dict, List, Mapping, Optional, Sequence

import torch

from repro_torch.ckpt import store
from repro_torch.p2p.overlay import rendezvous_placement

Tree = Mapping[str, Any]


def snapshot(tree: Tree) -> Dict[str, Any]:
    """A host copy of every leaf that shares no memory with the caller's."""
    out = {}
    for k, x in tree.items():
        if torch.is_tensor(x):
            out[k] = x.detach().to("cpu", copy=True)
        else:
            out[k] = store.to_numpy(x).copy()
    return out


@dataclass
class AsyncCheckpointer:
    root: str
    replicas: Sequence[str] = ()
    n_shards: int = 4
    replication_factor: Optional[int] = None  # R neighbours per step (HRW)
    keep: Optional[int] = None      # own images kept after each commit
    _q: queue.Queue = field(default_factory=lambda: queue.Queue(maxsize=2), repr=False)
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _exc: Optional[BaseException] = field(default=None, repr=False)
    _pending: int = field(default=0, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    last_blocking_seconds: float = field(default=0.0, repr=False)
    last_write_seconds: float = field(default=0.0, repr=False)
    _written: List[str] = field(default_factory=list, repr=False)

    def __post_init__(self):
        if self.keep is not None and self.keep < 1:
            raise ValueError(f"keep must be at least 1, got {self.keep}")
        os.makedirs(self.root, exist_ok=True)
        for r in self.replicas:
            os.makedirs(r, exist_ok=True)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, snap = item
            try:
                t0 = time.monotonic()
                path = store.save_pytree(self.root, step, snap, self.n_shards)
                for r in self._placement(step):
                    dst = os.path.join(r, os.path.basename(path))
                    # Atomic replication: copy into a ``.tmp`` sibling
                    # (invisible to list_checkpoints) and rename into place,
                    # so a crash mid-copy never leaves a half-written
                    # replica that looks committed.
                    tmp = dst + ".tmp"
                    if os.path.exists(tmp):
                        shutil.rmtree(tmp)
                    shutil.copytree(path, tmp)
                    if os.path.exists(dst):
                        shutil.rmtree(dst)
                    os.rename(tmp, dst)
                self.last_write_seconds = time.monotonic() - t0
                if self.keep is not None:
                    self._retain(os.path.basename(path))
            except BaseException as e:
                self._exc = e
            finally:
                with self._lock:
                    self._pending -= 1

    def _retain(self, name: str) -> None:
        """Record a committed image; drop own images beyond the newest
        ``keep``."""
        if name in self._written:
            self._written.remove(name)
        self._written.append(name)
        for old in self._written[:-self.keep]:
            for root in (self.root, *self.replicas):
                shutil.rmtree(os.path.join(root, old), ignore_errors=True)
        del self._written[:-self.keep]

    def _placement(self, step: int) -> Sequence[str]:
        """Replica directories receiving this step's image."""
        if self.replication_factor is None:
            return self.replicas
        return rendezvous_placement(f"step_{step}", list(self.replicas),
                                    self.replication_factor)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Tree) -> float:
        """Enqueue an async save.  Returns the BLOCKING seconds (the V the
        controller should see): the host snapshot + any queue backpressure."""
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        t0 = time.monotonic()
        snap = snapshot(tree)
        with self._lock:
            self._pending += 1
        self._q.put((step, snap))  # blocks only when 2 saves are queued
        blocking = time.monotonic() - t0
        self.last_blocking_seconds = blocking
        return blocking

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until all queued saves have landed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._pending == 0:
                    break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("async checkpoint writes did not finish")
            time.sleep(0.005)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------ #
    def restore_latest(self, like: Tree,
                       steps: Optional[Collection[int]] = None
                       ) -> Optional[tuple]:
        """(step, tree) from the newest checkpoint found anywhere, or among
        the images of ``steps`` only when it is given.

        Candidates from the primary and every replica are tried newest
        first (ties prefer the primary): with R-way placement the newest
        image may live only on the HRW-chosen neighbours, and a corrupt or
        missing copy falls back to the next-newest surviving replica.
        """
        found = []
        for root in (self.root, *self.replicas):
            cks = [(step, path) for step, path in store.list_checkpoints(root)
                   if steps is None or step in steps]
            if cks:
                found.append(cks[-1])
        for step, path in sorted(found, key=lambda sp: sp[0], reverse=True):
            try:
                return step, store.load_pytree(path, like)
            except Exception:
                continue  # corrupt copy: try the next candidate
        return None

    def gc(self, keep: int = 3) -> None:
        """Drop all but the newest ``keep`` checkpoints everywhere."""
        for root in (self.root, *self.replicas):
            cks = store.list_checkpoints(root)
            for _, path in cks[:-keep] if keep else cks:
                shutil.rmtree(path, ignore_errors=True)
