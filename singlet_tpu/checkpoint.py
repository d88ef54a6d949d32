"""Checkpoint / resume for long-running fits.

The reference has no mid-fit checkpointing — persistence exists only as
IVSparse matrix serialization (reference:src/singlet.cpp:843-945) and model
RDS snapshots after the fact (reference:R/cellxgene_pipeline.R:33-45); a
crashed multi-hour rank search restarts from zero. Here checkpointing is a
first-class subsystem: the complete fit state — (W, H, d), iteration
counter, tol / test-MSE traces, and a config fingerprint — is written
atomically every ``every`` iterations, and a resumed fit continues
bit-identically (ALS is deterministic given state: the speckled CV mask is a
stateless counter-RNG function of (seed, row, col), so no RNG state needs
saving beyond the integer mask seed).

Storage is a single ``.npz`` per checkpoint with a JSON config header;
writes go to a temp file + ``os.replace`` so a crash mid-write can never
corrupt the latest checkpoint. ``CheckpointManager`` keeps the newest
``keep`` checkpoints in a directory and resolves the latest on resume. A
config-fingerprint mismatch (different k, penalties, mask seed, or data
shape) makes resume refuse the stale state and start fresh.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["save_fit_state", "load_fit_state", "CheckpointManager"]

_ARRAY_KEYS = ("W", "H", "d")


def save_fit_state(path: str, state: Dict[str, Any]) -> None:
    """Atomically write a fit-state dict to ``path`` (.npz).

    ``state`` holds arrays under ``W``/``H``/``d``, scalars/lists under any
    other key (stored via a JSON side-channel entry).
    """
    arrays = {k: np.asarray(state[k]) for k in _ARRAY_KEYS if k in state}
    meta = {k: v for k, v in state.items() if k not in _ARRAY_KEYS}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_fit_state(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_fit_state`."""
    with np.load(path) as z:
        state: Dict[str, Any] = dict(
            json.loads(bytes(z["__meta__"].tobytes()).decode()))
        for k in _ARRAY_KEYS:
            if k in z:
                state[k] = z[k]
    return state


def _fingerprint(config: Dict[str, Any]) -> str:
    return json.dumps(config, sort_keys=True)


class CheckpointManager:
    """Directory of rolling fit checkpoints: ``ckpt_<iter>.npz``.

    Parameters
    ----------
    directory: where checkpoints live (created on first save).
    every: save cadence in iterations (0/None disables periodic saves;
        explicit ``save`` calls still work).
    keep: how many newest checkpoints to retain (older ones are deleted
        after a successful save — never before).
    """

    def __init__(self, directory: str, every: int = 10, keep: int = 2) -> None:
        self.directory = directory
        self.every = int(every or 0)
        self.keep = max(int(keep), 1)

    # -- paths ------------------------------------------------------------
    def _path(self, it: int) -> str:
        return os.path.join(self.directory, f"ckpt_{it:08d}.npz")

    def _all(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.directory, "ckpt_*.npz")))

    def latest_path(self) -> Optional[str]:
        paths = self._all()
        return paths[-1] if paths else None

    # -- save / restore ---------------------------------------------------
    def should_save(self, it: int) -> bool:
        """True when the cadence wants a save at this (1-based) iteration.
        Callers should test this BEFORE materializing device arrays to
        host — pulling W/H to the host is a device sync plus a copy."""
        return bool(self.every) and it % self.every == 0

    def maybe_save(self, it: int, state: Dict[str, Any]) -> bool:
        """Save if the cadence says so (iteration numbers are 1-based,
        i.e. pass the count of completed iterations)."""
        if self.should_save(it):
            self.save(it, state)
            return True
        return False

    def save(self, it: int, state: Dict[str, Any]) -> str:
        path = self._path(it)
        save_fit_state(path, dict(state, it=int(it)))
        for old in self._all()[: -self.keep]:
            try:
                os.unlink(old)
            except OSError:
                pass
        return path

    def restore(self, config: Dict[str, Any],
                verbose: bool = False) -> Optional[Dict[str, Any]]:
        """Load the newest checkpoint whose config fingerprint matches;
        returns None (fresh start) when absent or mismatched. ``config`` is
        the dict produced by :meth:`config_of` (or any dict — it is reduced
        to its fingerprint)."""
        want = config["config"] if set(config) == {"config"} \
            else _fingerprint(config)
        for path in reversed(self._all()):
            try:
                state = load_fit_state(path)
            except Exception:
                continue  # truncated/corrupt — atomic writes make this rare
            if state.get("config") == want:
                if verbose:
                    print(f"resuming from {path} (iter {state.get('it')})")
                return state
            if verbose:
                print(f"ignoring {path}: config fingerprint mismatch")
        return None

    @staticmethod
    def config_of(**kv: Any) -> Dict[str, Any]:
        """Build the fingerprintable config entry stored in every state."""
        return {"config": _fingerprint(kv)}


def resolve_manager(checkpoint, default_every: int = 10
                    ) -> Optional[CheckpointManager]:
    """Solvers accept ``checkpoint`` as a CheckpointManager or a directory
    path; normalize to a manager (or None)."""
    if checkpoint is None:
        return None
    if isinstance(checkpoint, CheckpointManager):
        return checkpoint
    return CheckpointManager(str(checkpoint), every=default_every)
