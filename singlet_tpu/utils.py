"""Small shared utilities: compilation cache, logging, timers."""

from __future__ import annotations

import os
import time

_CACHE_ENABLED = False

# fixed in-checkout cache path: the path is part of the cache key, so a
# directory that moves between runs never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``.jax_cache/`` at
    the root of the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Idempotently enable JAX's persistent compilation cache.

    Rank searches compile one program per (k, shape) combination; the cache
    amortizes that across fits and across processes. When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
    is set here; otherwise the cache goes to the fixed in-checkout path
    (``compilation_cache_dir``). ``SINGLET_TPU_NO_CACHE`` disables it.
    """
    global _CACHE_ENABLED
    if _CACHE_ENABLED or os.environ.get("SINGLET_TPU_NO_CACHE"):
        return
    _CACHE_ENABLED = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


class LazyModule:
    """Stand-in for a module that is imported on first attribute access, so
    optional dependencies (pandas, matplotlib) load only in the functions
    that use them. ``setup`` runs once, just before the import."""

    def __init__(self, name: str, setup=None):
        self._name = name
        self._setup = setup
        self._mod = None

    def __getattr__(self, attr):
        if self._mod is None:
            import importlib

            if self._setup is not None:
                self._setup()
            self._mod = importlib.import_module(self._name)
        return getattr(self._mod, attr)


def pandas_available() -> bool:
    """True when pandas can be imported."""
    try:
        import pandas  # noqa: F401
    except ImportError:
        return False
    return True


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0


def vprint(verbose: int, level: int, *args) -> None:
    if verbose >= level:
        print(*args, flush=True)


def is_scipy_sparse(A) -> bool:
    """True when A is a scipy sparse matrix (False when scipy is absent)."""
    try:
        import scipy.sparse as sp

        return sp.issparse(A)
    except ImportError:
        return False
