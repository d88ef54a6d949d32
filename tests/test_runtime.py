"""Run-time environment: compile-cache placement, the optional pandas and
matplotlib dependencies, and the device checks of chip_smoke.py and
bench.py (which must refuse to run on the CPU)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from singlet_tpu.solvers import drivers
from singlet_tpu.utils import DEFAULT_CACHE_DIR, compilation_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else \
        [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_default_cache_dir_is_inside_the_checkout():
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compilation_cache_dir_follows_the_env_var(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compilation_cache_dir() == DEFAULT_CACHE_DIR
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert compilation_cache_dir() == env_dir


@pytest.mark.parametrize("env_set", [False, True])
def test_enable_compilation_cache_placement(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting stands and the
    code sets nothing; unset, the cache goes to the fixed in-checkout
    path."""
    code = ("from singlet_tpu.utils import enable_compilation_cache\n"
            "enable_compilation_cache()\n"
            "import jax\n"
            "print('DIR=' + str(jax.config.jax_compilation_cache_dir))\n")
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    out = _run(code, extra)
    assert out.returncode == 0, out.stderr[-2000:]
    want = str(tmp_path) if env_set else DEFAULT_CACHE_DIR
    assert f"DIR={want}" in out.stdout


def test_main_path_runs_without_pandas_and_matplotlib():
    """import singlet_tpu + run_nmf + the CV table + get_best_rank with
    pandas and matplotlib unimportable; the table is then a dict of numpy
    columns."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import singlet_tpu as st\n"
        "rng = np.random.default_rng(0)\n"
        "A = rng.random((60, 40)).astype(np.float32)"
        " * (rng.random((60, 40)) < 0.3)\n"
        "m = st.run_nmf(A, rank=3, maxit=5)\n"
        "cv = st.cross_validate_nmf(A, ranks=[2, 3], n_replicates=1,"
        " maxit=4, verbose=0)\n"
        "assert isinstance(cv, dict), type(cv)\n"
        "assert set(cv) == {'k', 'rep', 'test_error', 'iter', 'tol'}\n"
        "print('RANK', st.get_best_rank(cv), m.w.shape)\n"
        "assert 'pandas' not in [k for k, v in sys.modules.items()"
        " if v is not None]\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RANK" in out.stdout


def test_trace_table_without_pandas_is_a_dict(monkeypatch):
    monkeypatch.setattr(drivers, "pandas_available", lambda: False)
    rows = [dict(k=2, rep=1, test_error=0.5, iter=0, tol=1.0),
            dict(k=3, rep=1, test_error=0.4, iter=0, tol=1.0)]
    t = drivers.trace_table(rows, ("k", "rep", "test_error", "iter", "tol"))
    assert isinstance(t, dict)
    np.testing.assert_array_equal(t["k"], [2, 3])
    np.testing.assert_allclose(t["test_error"], [0.5, 0.4])


def test_get_best_rank_same_on_dict_and_dataframe(rng):
    pd = pytest.importorskip("pandas")
    rows = []
    for rep in (1, 2):
        for k in (2, 4, 6, 8):
            for it in range(0, 20, 5):
                err = 1.0 / k + 0.01 * rng.random() + (0.3 if k == 8 and
                                                        it > 5 else 0.0)
                rows.append(dict(k=k, rep=rep, test_error=err, iter=it,
                                 tol=1e-3))
    cols = {c: np.asarray([r[c] for r in rows]) for c in rows[0]}
    assert drivers.get_best_rank(cols) == \
        drivers.get_best_rank(pd.DataFrame(rows))
    assert drivers.get_best_rank({}) == 2


def test_chip_smoke_refuses_the_cpu():
    out = _run([sys.executable, "chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_bench_refuses_the_cpu():
    out = _run([sys.executable, "bench.py"])
    assert out.returncode != 0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("device:")]
    assert json.loads(lines[0][len("device:"):])["platform"] == "cpu"
    assert '"metric"' not in out.stdout
