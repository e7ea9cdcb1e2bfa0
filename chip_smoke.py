#!/usr/bin/env python
"""Smoke run of the trial pipeline on one CUDA GPU, at full size.

    python chip_smoke.py [--seed N]          # one card
    python chip_smoke.py --four-cards        # the sharded BP paths only

Phases (each prints one line; any failure exits non-zero):

1. BP: the platform's decoder on the deployed 2048 x 18432 graph at
   B=512 with trial-like LLRs, against the ``exact`` reference decoder
   on the CPU at B=16 (converged codewords bit-identical).
2. Pair-HMM: the device entry (the CUDA kernel on the GPU) on 2048
   random pairs of 148-152 nt at Lmax=160, against the XLA formulation
   on the card (posteriors within 1e-5, EA scores equal) and on the CPU
   for 64 pairs (within 1e-4: the CPU's exp/log differ from CUDA's by an
   ulp, which the log-domain F + B - total cancellation at magnitudes of
   a few hundred turns into ~3e-5 absolute); times per chunk.
3. Trial: a seeded pool (272 codewords encoded on the deployed code,
   18,432 oligos of 152 nt), 68,000 simulated reads, decoded cold and
   warm through ``decode_trial``; both must return the oracle codewords.

``--four-cards`` runs only the coset-sharded blocked decoder over a
(cw=1, graph=4) mesh and the codeword-axis decoder over (cw=4, graph=1),
each compared bit for bit with the single-card decoder.

The last line printed is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import subprocess
import sys
import time


def card_line() -> str:
    """Name and power limit of the card, read by a child that never
    imports JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def phase_bp(graph, codewords, mode):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dna_ldpc_tpu.ops.bp import bp_decode
    from dna_ldpc_tpu.pipeline.simulate import trial_like_llrs

    B = 512
    cw = codewords[np.arange(B) % len(codewords)]
    llr = trial_like_llrs(cw, seed=7)
    t0 = time.perf_counter()
    r = bp_decode(graph, jnp.asarray(llr), max_iter=200, mode=mode)
    jax.block_until_ready(r.bits)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = bp_decode(graph, jnp.asarray(llr), max_iter=200, mode=mode)
    bits = np.asarray(r.bits)
    t_warm = time.perf_counter() - t0
    ok = np.asarray(r.success)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = bp_decode(graph, jnp.asarray(llr[:16]), max_iter=200, mode="exact")
        ref_bits, ref_ok = np.asarray(ref.bits), np.asarray(ref.success)
    both = ok[:16] & ref_ok
    check(ok.all(), f"BP: {int((~ok).sum())} of {B} codewords did not converge")
    check(ref_ok.all(), "BP: CPU reference did not converge")
    check(np.array_equal(bits[:16][both], ref_bits[both]), "BP: bits differ from the CPU reference")
    check(np.array_equal(bits, cw), "BP: decoded bits differ from the codewords")
    log(
        f"phase bp: mode={mode} B={B} converged={int(ok.sum())}/{B} "
        f"iters_max={int(np.asarray(r.iterations).max())} "
        f"cpu_exact_B16_bit_identical=True first_call_s={t_first:.3f} warm_s={t_warm:.4f}"
    )


def _time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())  # compile / warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def phase_pairhmm(seed):
    import jax
    import numpy as np

    from dna_ldpc_tpu.ops.msa import pairhmm

    rng = np.random.default_rng(seed)
    P, Lmax = 2048, 160
    xs = ["".join("ACGT"[c] for c in rng.integers(0, 4, rng.integers(148, 153))) for _ in range(P)]
    ys = []
    for x in xs:  # related pairs: a few substitutions and one deletion
        b = list(x)
        for k in rng.integers(0, len(b), 3):
            b[k] = "ACGT"[rng.integers(0, 4)]
        del b[rng.integers(0, len(b))]
        ys.append("".join(b))
    X, Y, lx, ly, _ = pairhmm.encode_pairs(xs, ys, Lmax)

    t0 = time.perf_counter()
    post, ea, _, _, _ = pairhmm.batch_post_ea(xs, ys, Lmax)
    jax.block_until_ready(post)
    t_first = time.perf_counter() - t0
    with jax.default_matmul_precision("highest"):
        ref_post, ref_ea = pairhmm._post_ea_xla(X, Y, lx, ly, Lmax)
    post, ea = np.asarray(post), np.asarray(ea)
    ref_post, ref_ea = np.asarray(ref_post), np.asarray(ref_ea)
    err = float(np.abs(post - ref_post).max())
    ea_equal = int((ea == ref_ea).sum())
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_post, cpu_ea = pairhmm._post_ea_xla(X[:64], Y[:64], lx[:64], ly[:64], Lmax)
        cpu_post, cpu_ea = np.asarray(cpu_post), np.asarray(cpu_ea)
    err_cpu = float(np.abs(post[:64] - cpu_post).max())
    cpu_ea_equal = int((ea[:64] == cpu_ea).sum())

    from dna_ldpc_tpu.ops.msa.pairhmm_cuda import post_ea_cuda

    t_kernel = _time(lambda: post_ea_cuda(X, Y, lx, ly))
    t_xla = _time(lambda: pairhmm._post_ea_xla(X, Y, lx, ly, Lmax))
    log(
        f"phase pairhmm: P={P} Lmax={Lmax} max_abs_err_vs_xla={err:.3g} "
        f"ea_equal={ea_equal}/{P} max_abs_err_vs_cpu64={err_cpu:.3g} "
        f"cpu_ea_equal={cpu_ea_equal}/64 first_call_s={t_first:.3f} "
        f"kernel_chunk_s={t_kernel:.5f} xla_chunk_s={t_xla:.5f}"
    )
    check(err <= 1e-5, f"pair-HMM: posteriors differ from XLA by {err}")
    check(ea_equal == P, "pair-HMM: EA scores differ from XLA")
    check(err_cpu <= 1e-4 and cpu_ea_equal == 64, "pair-HMM: differs from the CPU")


def phase_trial(graph, codewords, oligos, seed):
    import jax
    import numpy as np

    from dna_ldpc_tpu.pipeline.decode import TrialConfig, decode_trial
    from dna_ldpc_tpu.pipeline.simulate import ChannelModel, simulate_reads

    reads, quals = simulate_reads(oligos, 68000, ChannelModel(), seed=seed)
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        r = decode_trial(reads, quals, codewords, TrialConfig(), graph=graph)
        secs = time.perf_counter() - t0
        n_ok = int((r.decoded_bits == codewords).all(axis=1).sum())
        phases = {k: round(float(v), 4) for k, v in r.phase_times.items()}
        peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
        log(
            f"phase trial_{label}: reads={len(reads)} kept={r.n_reads_kept} "
            f"decoded={n_ok}/272 first_fail={len(r.fail_first)} "
            f"anneal_rounds={r.n_anneal_iters} seconds={secs:.3f} "
            f"host_aligner_clusters={int(r.phase_times.get('llr_host_fallback_clusters', 0))} "
            f"peak_bytes_in_use={peak} phase_times={json.dumps(phases)}"
        )
        check(r.success and n_ok == 272, f"trial ({label}): {n_ok}/272 codewords decoded")


def phase_four_cards(graph, codewords, B=512):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dna_ldpc_tpu.ops.bp import bp_decode
    from dna_ldpc_tpu.parallel.mesh import CW_AXIS, GRAPH_AXIS
    from dna_ldpc_tpu.parallel.sharded_bp import (
        make_sharded_blocked_decoder,
        make_sharded_cw_decoder,
    )
    from dna_ldpc_tpu.pipeline.decode import _auto_bp_mode
    from dna_ldpc_tpu.pipeline.simulate import trial_like_llrs

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}")
    cw = codewords[np.arange(B) % len(codewords)]
    llr = trial_like_llrs(cw, seed=11)
    mode = _auto_bp_mode()
    cases = [
        ("blocked_graph4", Mesh(np.array(devs).reshape(1, 4), (CW_AXIS, GRAPH_AXIS)),
         lambda m: make_sharded_blocked_decoder(graph.blocked, m, 200), "exact"),
        ("cw4", Mesh(np.array(devs).reshape(4, 1), (CW_AXIS, GRAPH_AXIS)),
         lambda m: make_sharded_cw_decoder(graph, m, 200, mode), mode),
    ]
    for name, mesh, make, ref_mode in cases:
        with jax.default_device(devs[0]):
            ref = bp_decode(graph, jnp.asarray(llr), max_iter=200, mode=ref_mode)
            ref_bits = np.asarray(ref.bits)
        x = jax.device_put(jnp.asarray(llr), NamedSharding(mesh, P(CW_AXIS, None)))
        decode = make(mesh)
        jax.block_until_ready(decode(x).bits)
        t0 = time.perf_counter()
        r = decode(x)
        bits = np.asarray(r.bits)
        secs = time.perf_counter() - t0
        same = bool(np.array_equal(bits, ref_bits))
        same_iters = bool(np.array_equal(np.asarray(r.iterations), np.asarray(ref.iterations)))
        log(
            f"phase {name}: mesh={dict(mesh.shape)} ref_mode={ref_mode} B={B} "
            f"bit_identical_to_single_card={same} iterations_equal={same_iters} "
            f"all_codewords={bool(np.array_equal(bits, cw))} warm_s={secs:.4f}"
        )
        check(same, f"{name}: bits differ from the single-card decoder")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    d0 = devs[0]
    log(f"devices: platform={d0.platform} kind={d0.device_kind} count={len(devs)}")
    if d0.platform != "gpu":
        log("no CUDA GPU found: this smoke run needs one")
        return 1
    log(f"card: {card_line()}")

    import numpy as np

    from dna_ldpc_tpu.pipeline.decode import _auto_bp_mode, deployed_graph
    from dna_ldpc_tpu.pipeline.simulate import synthetic_pool

    t0 = time.perf_counter()
    graph = deployed_graph()
    codewords, oligos = synthetic_pool(args.seed)
    log(f"setup: seeded pool of {len(oligos)} oligos, {len(codewords)} codewords "
        f"in {time.perf_counter() - t0:.1f}s")

    if args.four_cards:
        phase_four_cards(graph, codewords)
    else:
        phase_bp(graph, codewords, _auto_bp_mode())
        phase_pairhmm(args.seed)
        phase_trial(graph, codewords, oligos, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
