"""pbmc3k cross-validation through the MESH-routed drivers (sharded ELL
engine + fused ard loops + k_bucket program sharing) — the wall-clock
counterpart of the single-chip CV number in BASELINE.md.

Run: python benchmarks/mesh_cv.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from singlet_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    from singlet_tpu.data import load_pbmc3k
    from singlet_tpu.parallel.sharded import make_mesh
    from singlet_tpu.preprocess import log_normalize
    from singlet_tpu.solvers import drivers

    ds = load_pbmc3k()
    A = log_normalize(ds.counts)
    mesh = make_mesh(min(len(jax.devices()), 8))

    t0 = time.perf_counter()
    df = drivers.cross_validate_nmf(A, ranks=list(range(2, 31, 2)),
                                    n_replicates=3, verbose=0, seed=123,
                                    mesh=mesh)
    best = drivers.get_best_rank(df)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "pbmc3k_mesh_cv_k2_30s2_reps3_wall_s",
        "value": round(dt, 1), "unit": "s", "rank": int(best),
        "n_devices": int(mesh.devices.size),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
