"""Structured tracing, metric logging, and profiler integration.

The reference's observability is console-only: per-iteration ``iter | tol``
tables (reference:src/singlet.cpp:644,661-662,1103) plus R verbosity gating
(reference:R/ard_nmf.R:119-132) and one ``system.time`` wall-clock capture
(reference:R/cellxgene_pipeline.R:27-29). This module upgrades that to a
structured subsystem:

  * ``MetricLogger`` — per-iteration JSONL event records (fit id, event,
    iter, tol, test_mse, wall-clock ms, ...), written incrementally so a
    crashed run leaves a complete trace up to the failure point;
  * ``profile(logdir)`` — context manager around ``jax.profiler`` traces for
    XLA-level inspection (TensorBoard / xprof);
  * module-level default logger so solvers emit events without threading a
    logger argument through every call.

Events never raise into the fit path: a logging failure is reported once and
logging is disabled for the remainder of the run.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

__all__ = [
    "MetricLogger",
    "NULL_LOGGER",
    "get_metric_logger",
    "set_metric_logger",
    "metric_logging",
    "profile",
]


class MetricLogger:
    """Append-only structured event log (JSONL) + in-memory event list.

    Each event is one JSON object per line:
    ``{"ts": <unix float>, "fit": <id>, "event": <name>, ...fields}``.
    Thread-safe; solvers running in worker threads share one logger.
    """

    def __init__(self, path: Optional[str] = None,
                 keep_in_memory: bool = True) -> None:
        self.path = path
        self.keep_in_memory = keep_in_memory
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOBase] = None
        self._broken = False
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def new_fit_id(self, prefix: str = "fit") -> str:
        return f"{prefix}-{uuid.uuid4().hex[:8]}"

    def log(self, event: str, fit: Optional[str] = None, **fields: Any) -> None:
        if self._broken:
            return
        rec = {"ts": time.time(), "event": event}
        if fit is not None:
            rec["fit"] = fit
        rec.update(fields)
        try:
            with self._lock:
                if self.keep_in_memory:
                    self.events.append(rec)
                if self._fh is not None:
                    self._fh.write(json.dumps(rec) + "\n")
        except Exception as exc:  # never break the fit because of logging
            self._broken = True
            print(f"singlet_tpu.tracing: metric logging disabled ({exc!r})")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class _NullLogger(MetricLogger):
    """Default no-op logger: ``log`` is a cheap early-out."""

    def __init__(self) -> None:
        super().__init__(path=None, keep_in_memory=False)

    def log(self, event: str, fit: Optional[str] = None, **fields: Any) -> None:
        pass


NULL_LOGGER = _NullLogger()
_current: MetricLogger = NULL_LOGGER


def get_metric_logger() -> MetricLogger:
    return _current


def set_metric_logger(logger: Optional[MetricLogger]) -> MetricLogger:
    """Install ``logger`` as the process-wide default; returns the previous
    one so callers can restore it."""
    global _current
    prev = _current
    _current = logger if logger is not None else NULL_LOGGER
    return prev


@contextlib.contextmanager
def metric_logging(path: Optional[str] = None, keep_in_memory: bool = True):
    """Scoped metric logging: installs a fresh ``MetricLogger`` as the
    default for the with-block and restores the previous one after."""
    logger = MetricLogger(path=path, keep_in_memory=keep_in_memory)
    prev = set_metric_logger(logger)
    try:
        yield logger
    finally:
        set_metric_logger(prev)
        logger.close()


@contextlib.contextmanager
def profile(logdir: str, enabled: bool = True):
    """XLA-level profiler trace around a fit (view with TensorBoard/xprof).

    ``with profile("traces/"): run_nmf(...)``. No-op when disabled so
    callers can gate on a flag without restructuring.
    """
    if not enabled:
        yield
        return
    import jax

    os.makedirs(logdir, exist_ok=True)
    with jax.profiler.trace(logdir):
        yield
