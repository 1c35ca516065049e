"""MFU / roofline accounting for the beam kernel.

Counts FLOPs and device-memory bytes per _step_planes (kernels/beam.py,
the planes impl for R <= _R_CHUNK) analytically from the dispatch
shape, then measures the mixed-ploidy sweep at several batch sizes G
and reports achieved FLOP/s, memory bandwidth, and their share of the
device's published peaks (PEAKS, keyed by JAX's device_kind; a device
not in the table is an error). The reference work unit being modeled
is one read insertion into every beam slot
(global_clustering.rs:49-147).

Cost model (impl=planes, exact arithmetic): the beam state is the
persistent f32 count-plane pair cnt [B, P, 2A, S]; each step permutes it
by a one-hot matmul at EXACT_MATMUL_PRECISION (plain f32, outside the
tensor cores on a GPU), adds the read's row planes, and scores the read
against the window. Per scan step (B slots in, `out` slots out, ploidy
P, A alleles, window Wn == S):

  FLOPs (logical):
    permutation einsum : 2*out*B*P*2A*Wn
    row update         : 2*out*P*2A*Wn
    scoring (at/empty/cmp/mask reductions over plane pair): ~12*B*P*A*Wn
    newhist gather     : 2*out*B*P*R
    rank-select        : ~3*(B*P)^2
    dedup (2 fp)       : ~4*B*P*R
  Memory bytes (f32; upper bound — XLA fuses some rereads):
    cnt window read + permuted write : 4*Wn*2A*P*(B + out)
    scoring rereads of the window    : ~2 * 4*B*P*2A*Wn
    hist r/w                         : 2*4*B*P*R
    read row planes / masks          : ~4*(2A+2)*Wn

Usage:  python scripts/mfu.py            (on a GPU; measures a G sweep)
        python scripts/mfu.py --model    (print the analytic table only)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Published peaks per device_kind, dense rates without sparsity. Source:
# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column (rates assume the
# full 700 W power limit): bf16 989 TFLOP/s, TF32 495 TFLOP/s, f32 67
# TFLOP/s outside the tensor cores, f64 34 TFLOP/s (67 on the tensor
# cores), HBM3 3.35 TB/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                              "f32": 67e12, "f64": 34e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    """The PEAKS row of device_kind; KeyError for an unknown device."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add them to scripts/mfu.py "
                       f"PEAKS with their source")
    return PEAKS[device_kind]


def step_flops(B, P, R, A, Wn, out):
    perm = 2.0 * out * B * P * 2 * A * Wn
    update = 2.0 * out * P * 2 * A * Wn
    score = 12.0 * B * P * A * Wn
    gather = 2.0 * out * B * P * R
    rank = 3.0 * (B * P) ** 2
    dedup = 4.0 * B * P * R
    return perm + update + score + gather + rank + dedup


def step_bytes(B, P, R, A, Wn, out):
    cnt_rw = 4.0 * Wn * 2 * A * P * (B + out)
    score_rd = 2 * 4.0 * B * P * 2 * A * Wn
    hist = 2 * 4.0 * B * P * R
    rows = 4.0 * (2 * A + 2) * Wn
    return cnt_rw + score_rd + hist + rows


def sweep_cost(R, S, ploidies, W, A=2, T1=25):
    """(FLOPs, bytes) for one block phased at every ploidy in
    `ploidies` (the bench's mixed sweep), full-S window."""
    fl = by = 0.0
    for p in ploidies:
        B1 = p * W
        warm = min(T1, R)
        fl += warm * step_flops(B1, p, R, A, S, B1)
        by += warm * step_bytes(B1, p, R, A, S, B1)
        if R > T1:
            fl += step_flops(B1, p, R, A, S, W)
            by += step_bytes(B1, p, R, A, S, W)
            fl += (R - T1 - 1) * step_flops(W, p, R, A, S, W)
            by += (R - T1 - 1) * step_bytes(W, p, R, A, S, W)
    return fl, by


def model_table(configs):
    rows = []
    for (R, S) in configs:
        fl, by = sweep_cost(R, S, (2, 3, 4, 5), 10)
        rows.append({"R": R, "S": S,
                     "sweep_gflops_per_block": round(fl / 1e9, 2),
                     "sweep_mb_per_block": round(by / 1e6, 1),
                     "arith_intensity_flop_per_byte":
                         round(fl / by, 2)})
    return rows


def measure(G_list, R, S):
    import jax

    peak = peaks_for(jax.devices()[0].device_kind)

    from bench import make_workload
    from floria_tpu.kernels.beam import beam_search_batch_mixed

    ploidies = (2, 3, 4, 5)
    out = []
    for G in G_list:
        alleles, weights, num_reads, eps = make_workload(G, R, S)
        a4 = jax.device_put(np.concatenate([alleles] * len(ploidies)))
        w4 = jax.device_put(np.concatenate([weights] * len(ploidies)))
        n4 = jax.device_put(np.concatenate([num_reads] * len(ploidies)))
        e4 = jax.device_put(np.concatenate([eps] * len(ploidies)))
        nparts = jax.device_put(
            np.repeat(np.array(ploidies, np.int32), G))

        def sweep():
            r = beam_search_batch_mixed(a4, w4, n4, e4, nparts,
                                        max(ploidies), 10, max_alleles=2)
            jax.block_until_ready(r)

        sweep()
        iters = 3
        t0 = time.time()
        for _ in range(iters):
            sweep()
        dt = (time.time() - t0) / iters
        fl, by = sweep_cost(R, S, ploidies, 10)
        fl *= G
        by *= G
        out.append({
            "G": G, "R": R, "S": S,
            "sweep_s": round(dt, 3),
            "reads_per_sec": round(G * R * len(ploidies) / dt, 1),
            "achieved_tflops": round(fl / dt / 1e12, 3),
            "device_kind": jax.devices()[0].device_kind,
            "mfu_vs_f32_peak_pct": round(100 * fl / dt / peak["f32"], 2),
            "hbm_gbps_upper_bound": round(by / dt / 1e9, 1),
            "hbm_frac_pct": round(
                100 * by / dt / peak["hbm_bytes_per_s"], 1),
        })
        print(json.dumps(out[-1]), flush=True)
    return out


def main():
    cfgs = [(256, 256), (320, 2048)]
    print(json.dumps({"model": model_table(cfgs)}, indent=1))
    if "--model" in sys.argv:
        return
    for (R, S), gl in zip(cfgs, ([32, 64, 128], [8, 16, 32])):
        measure(gl, R, S)


if __name__ == "__main__":
    main()
