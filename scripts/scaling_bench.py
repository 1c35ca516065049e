"""Block-shard scaling: blocks/s at 1/2/4/8 devices on a virtual CPU
mesh (or real devices when available).

Usage: python scripts/scaling_bench.py            (8 virtual CPU devices)
       JAX_PLATFORMS=cuda python scripts/scaling_bench.py  (real GPUs)
"""

import os
import sys
import time

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from bench import make_workload  # noqa: E402


def main():
    import jax

    from floria_tpu.parallel.mesh import (beam_search_sharded,
                                          make_block_mesh)

    print("devices:", len(jax.devices()), flush=True)
    G, R, S = 32, 128, 256
    alleles, weights, num_reads, eps = make_workload(G, R, S)
    nparts = np.full(G, 3, dtype=np.int32)

    results = {}
    for n_dev in (1, 2, 4, 8):
        if n_dev > len(jax.local_devices()):
            break
        mesh = make_block_mesh(n_dev)

        def run():
            out = beam_search_sharded(mesh, alleles, weights, num_reads,
                                      eps, nparts, 3, 10)
            return out

        run()  # compile
        t0 = time.time()
        iters = 3
        for _ in range(iters):
            run()
        per = (time.time() - t0) / iters
        results[n_dev] = G * iters / (per * iters)
        eff = (results[n_dev] / (results[1] * n_dev)) if 1 in results \
            else 1.0
        print(f"n_dev={n_dev}: {results[n_dev]:8.1f} blocks/s  "
              f"efficiency={eff:.2f}", flush=True)


if __name__ == "__main__":
    main()
