#!/usr/bin/env python
"""Benchmark on one CUDA GPU: BP decoder throughput on the deployed
n=18432 code and one end-to-end trial, cold and warm, in one process.

    python bench.py                    # headline JSON line
    python bench.py --bp-formulations  # time every XLA BP formulation

The workload is generated from ``--seed``: 272 random codewords encoded
on the deployed code, their 18,432 oligos, and 68,000 simulated reads.
Prints one JSON line naming the device. A missing GPU is an error.
"""

import argparse
import json
import time

import numpy as np

BASELINE_CW_PER_S = 0.21  # reference CPU pipeline: 272 codewords per ~1300 s trial


def _timed(fn, reps):
    fn()  # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def bp_seconds(graph, llr, mode, max_iter, early_stop, reps=5):
    """Median seconds of one decode; ends in a host read of the results."""
    import jax.numpy as jnp

    from dna_ldpc_tpu.ops.bp import bp_decode

    x = jnp.asarray(llr)

    def run():
        r = bp_decode(graph, x, max_iter=max_iter, early_stop=early_stop, mode=mode)
        return np.asarray(r.unsat)

    unsat = run()
    if early_stop and not (unsat == 0).all():
        raise RuntimeError(f"{mode}: the bench workload did not converge")
    t = _timed(run, reps)
    return t[len(t) // 2]


def bp_formulations(graph, codewords):
    """Every XLA formulation at the trial's shapes: B=512 (the first
    decode pads 272 to 512) with early stop at max 200 iterations and
    with 50 fixed iterations, and B=1, 2 (anneal rounds) with early
    stop."""
    from dna_ldpc_tpu.pipeline.simulate import trial_like_llrs

    rows = []
    for mode in ("gather", "exact", "bf16"):
        for B, max_iter, early in ((512, 200, True), (512, 50, False), (2, 200, True), (1, 200, True)):
            cw = codewords[np.arange(B) % len(codewords)]
            llr = trial_like_llrs(cw, seed=7)
            t0 = time.perf_counter()
            s = bp_seconds(graph, llr, mode, max_iter, early)
            rows.append({
                "mode": mode, "B": B, "max_iter": max_iter, "early_stop": early,
                "seconds": s, "codewords_per_s": B / s,
                "setup_s": time.perf_counter() - t0,
            })
            print(json.dumps(rows[-1]), flush=True)
    return rows


def trial(graph, codewords, oligos, seed):
    from dna_ldpc_tpu.pipeline.decode import TrialConfig, decode_trial
    from dna_ldpc_tpu.pipeline.simulate import ChannelModel, simulate_reads

    reads, quals = simulate_reads(oligos, 68000, ChannelModel(), seed=seed)
    out = {}
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        r = decode_trial(reads, quals, codewords, TrialConfig(), graph=graph)
        secs = time.perf_counter() - t0
        if not (r.success and (r.decoded_bits == codewords).all()):
            raise RuntimeError(f"trial ({label}) did not decode to the oracle codewords")
        out[f"end_to_end_trial_{label}_seconds"] = secs
        out[f"end_to_end_{label}_phase_times"] = r.phase_times
    out["end_to_end_warm_codewords_per_s"] = 272.0 / out["end_to_end_trial_warm_seconds"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bp-formulations", action="store_true")
    args = ap.parse_args()

    import jax

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        raise RuntimeError(f"bench.py measures a CUDA GPU; JAX found {d0.platform!r}")
    device = {"platform": d0.platform, "kind": d0.device_kind, "count": len(jax.devices())}

    from dna_ldpc_tpu.pipeline.decode import _auto_bp_mode, deployed_graph
    from dna_ldpc_tpu.pipeline.simulate import synthetic_pool, trial_like_llrs

    graph = deployed_graph()
    codewords, oligos = synthetic_pool(args.seed)
    if args.bp_formulations:
        print(json.dumps({"device": device, "bp_formulations": bp_formulations(graph, codewords)}))
        return

    mode = _auto_bp_mode()
    B = 512
    llr = trial_like_llrs(codewords[np.arange(B) % len(codewords)], seed=7)
    value = B / bp_seconds(graph, llr, mode, 200, True)
    fixed50 = B / bp_seconds(graph, llr, mode, 50, False, reps=3)
    out = {
        "metric": f"decoded codewords/s (n=18432, BP mode {mode}, sum-product, max 200 iters, "
                  f"syndrome early stop; trial-like channel, batch {B})",
        "device": device,
        "value": value,
        "unit": "codewords/s",
        "vs_baseline": value / BASELINE_CW_PER_S,
        "fixed50_codewords_per_s": fixed50,
    }
    out.update(trial(graph, codewords, oligos, args.seed))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
