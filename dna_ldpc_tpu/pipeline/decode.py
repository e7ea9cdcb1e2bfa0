"""End-to-end trial decoding: reads -> soft information -> batched BP ->
epsilon-annealing re-decode -> result report.

Batched redesign of the reference trial driver (``ex_decoder/
decoder.py:44-727``): where the reference spawns one ldpc.exe process per
codeword (272 sequential invocations, decoder.py:553-558) and re-runs
failures one at a time through re-scaled soft files, here all 272 codewords
of a trial decode as ONE batched BP call, and each annealing round re-runs
only the failing subset as a single smaller batch.

Semantics mirrored exactly:

- first decoding failure = any bit mismatch vs the oracle codeword
  (decoder.py:565-581), not syndrome success;
- ``re_decode`` counters: bits where the decoder output differs from the
  channel hard decision (LLR >= 0 -> 0), thresholded at 140 to report
  "erasure strands" (decoder.py:544, 571-573, 591);
- annealing: epsil2 starts at eps-0.0005; each round rescales the ORIGINAL
  soft values by log((1-eps')/eps')/log((1-eps)/eps) with
  eps' = epsil2-0.0005 (zeros stay zero), decrements epsil2 by 0.0005, and
  stops when no failures remain or epsil2 <= 0.001 (decoder.py:594-664).

Reference quirk NOT reproduced by default: the reference's second-decoding
loop resets its failure list inside the per-codeword loop
(decoder.py:660-662), so only the LAST re-decoded codeword's failure
survives a round — earlier failures are silently dropped from subsequent
rounds (and from the final report). The bundled golden trials are
unaffected (their failure sets make both semantics identical);
``strict_reference_failure_tracking=True`` reproduces the literal behavior.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..models.codebook import N_STRANDS, PAYLOAD_BITS
from ..models.ldpc_graph import LdpcGraph
from ..models.rs_ldpc import dna_storage_pchk
from ..ops.bp import bp_decode
from .llr import Aligner, FilteredReads, compute_trial_llrs, rs_filter_reads

ERASURE_THRESHOLD = 140  # decoder.py:591


@dataclass
class TrialConfig:
    epsil: float = 0.02
    max_iter: int = 200          # def_func.py:49 (ldpc argv max_iter)
    anneal_step: float = 0.0005
    anneal_floor: float = 0.001
    strict_reference_failure_tracking: bool = False
    max_decode_batch: int = 1024
    # BP formulation: None = chosen by platform (_auto_bp_mode);
    # "gather"/"exact"/"fast"/"bf16" to force (ops/bp.py docstrings)
    bp_mode: str | None = None


@dataclass
class TrialResult:
    success: bool
    fail_first: list[int]        # 1-based codeword indices, first decoding
    fail_final: list[int]
    n_anneal_iters: int
    n_erasure_strands: int
    decoded_bits: np.ndarray     # [272, 18432] final decoder outputs
    total_time: float
    phase_times: dict = field(default_factory=dict)
    n_reads_kept: int = 0


_graph_cache: dict[int, LdpcGraph] = {}


def deployed_graph() -> LdpcGraph:
    if 0 not in _graph_cache:
        import dataclasses

        from ..models.blocked import dna_storage_blocked

        # the shipped pchk is column-shuffled, so natural block detection
        # fails; attach the known canonical decomposition explicitly to
        # enable the one-hot routing decoders
        g = LdpcGraph.from_sparse(dna_storage_pchk(), detect_blocked=False)
        _graph_cache[0] = dataclasses.replace(g, blocked=dna_storage_blocked())
    return _graph_cache[0]


# BP formulation per JAX platform. GPU: "gather" keeps exact f32
# semantics, is the fastest at the anneal rounds' B=1-2, and trails the
# FER-parity-only "bf16" mode by ~7 ms at B=512 (H100 timings in
# PERF.md). CPU: the "exact" reference the tests compare against.
BP_MODE_BY_PLATFORM = {"gpu": "gather", "cpu": "exact"}


def _auto_bp_mode(platform: str | None = None) -> str:
    """The BP formulation for ``platform`` (default: JAX's default
    backend). A platform without a measured choice is an error."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return BP_MODE_BY_PLATFORM[platform]
    except KeyError:
        raise ValueError(
            f"no BP formulation chosen for platform {platform!r} "
            f"(known: {sorted(BP_MODE_BY_PLATFORM)})"
        ) from None


def _decode_batch(graph, llrs: np.ndarray, max_iter: int, mode: str | None = None) -> np.ndarray:
    """BP-decode [K, N] float soft values -> [K, N] hard outputs.

    The batch is padded to a power of two so the annealing loop's varying
    failure counts reuse one compiled decoder per bucket (all-zero pad rows
    decode instantly at iteration 0)."""
    import jax.numpy as jnp

    K = len(llrs)
    Kb = 1 << (K - 1).bit_length() if K > 1 else 1
    if Kb != K:
        llrs = np.concatenate([llrs, np.zeros((Kb - K, llrs.shape[1]), llrs.dtype)])
    res = bp_decode(graph, jnp.asarray(llrs, jnp.float32), max_iter=max_iter, mode=mode)
    return np.asarray(res.bits)[:K]


def anneal_decode(
    graph: LdpcGraph,
    soft: np.ndarray,
    codewords: np.ndarray,
    config: TrialConfig = TrialConfig(),
    phase: dict | None = None,
    resume: tuple[np.ndarray, list[int], list[int], int] | None = None,
    save_cb=None,
) -> tuple[np.ndarray, list[int], list[int], int]:
    """First decoding of all codewords in one batch, then the reference's
    second-decoding epsilon-annealing loop over failures
    (``ex_decoder/decoder.py:553-664``): rescale the ORIGINAL soft values
    to effective eps' = epsil2 - step (zeros stay zero) and re-decode only
    the still-failing codewords until all succeed or eps bottoms out.

    Returns (decoded bits [K, N], fail_first, fail_final, n_anneal_iters);
    failure indices are 1-based codeword numbers as the reference reports
    them.

    ``resume`` = (decoded bits, fail_first, fail_current, n_anneal_iters)
    from a checkpoint: skips the first decode and restarts the annealing
    loop at the epsilon it had reached. ``save_cb(dec, fail_first, fail,
    n_iters)``, when given, is invoked after the first decode and after
    every annealing round (decoder-progress checkpointing)."""
    phase = phase if phase is not None else {}

    bp_mode = config.bp_mode if config.bp_mode is not None else _auto_bp_mode()
    if resume is not None:
        dec, fail_first, fail, n_iters = resume
        dec = np.array(dec)
        fail = list(fail)
        fail_first = list(fail_first)
        phase["first_decode"] = 0.0
    else:
        t0 = time.time()
        # np.asarray of a JAX array is read-only; the annealing loop writes rows
        dec = np.array(_decode_batch(graph, soft, config.max_iter, bp_mode))
        phase["first_decode"] = time.time() - t0

        errs = (dec != codewords).sum(axis=1)
        fail_first = [int(i) + 1 for i in np.nonzero(errs)[0]]
        fail = list(fail_first)
        n_iters = 0
        if save_cb is not None:
            save_cb(dec, fail_first, fail, n_iters)

    t0 = time.time()
    epsil2 = config.epsil - config.anneal_step * (n_iters + 1)
    base_mag = np.log((1 - config.epsil) / config.epsil)
    while fail and epsil2 > config.anneal_floor:
        n_iters += 1
        eps_eff = epsil2 - config.anneal_step
        scale = np.log((1 - eps_eff) / eps_eff) / base_mag
        idx = np.array(fail) - 1
        re_soft = soft[idx] * scale  # zeros stay zero
        epsil2 -= config.anneal_step

        dec_f = _decode_batch(graph, re_soft, config.max_iter, bp_mode)
        dec[idx] = dec_f
        errs_f = (dec_f != codewords[idx]).sum(axis=1)
        if config.strict_reference_failure_tracking:
            # literal decoder.py:660-662: only the last failure survives
            fail = [fail[-1]] if errs_f[-1] != 0 else []
        else:
            fail = [int(fail[k]) for k in range(len(fail)) if errs_f[k] != 0]
        if save_cb is not None:
            save_cb(dec, fail_first, fail, n_iters)
    phase["second_decode"] = time.time() - t0
    return dec, fail_first, fail, n_iters


def decode_trial(
    reads: Sequence[str],
    quals: Sequence[str | int],
    codewords: np.ndarray,
    config: TrialConfig = TrialConfig(),
    aligner: Aligner | None = None,
    graph: LdpcGraph | None = None,
    checkpoint_path: str | None = None,
) -> TrialResult:
    """Decode one trial. codewords: [272, 18432] oracle bits (the shipped
    ``codeword_n18432_m1860_*`` files), used for error counting exactly as
    the reference does.

    ``checkpoint_path``: optional npz path; if it holds a checkpoint for
    the same epsilon, the ingest (RS + clustering + MSA + counting) stage
    is skipped and decoding resumes from the stored LLR table — and, when
    the checkpoint also carries decoder progress (decoded bits + current
    failure set), the first decode is skipped and the annealing loop
    restarts at the epsilon it had reached. The checkpoint is written
    after ingest and updated after the first decode and after every
    annealing round."""
    t_start = time.time()
    graph = graph or deployed_graph()
    # aligner=None routes mixed clusters through the cross-cluster batched
    # MSA path inside compute_trial_llrs (the production default)
    phase = {}

    ckpt = None
    if checkpoint_path:
        from .checkpoint import TrialCheckpoint

        ckpt = TrialCheckpoint.load(checkpoint_path)
        if ckpt is not None and abs(ckpt.epsil - config.epsil) > 1e-12:
            ckpt = None

    if ckpt is not None:
        llr_table = ckpt.llr_table
        soft = llr_table.T.copy()
        n_kept = ckpt.n_reads_kept
        phase["rs_decode"] = phase["llr"] = 0.0
    else:
        t0 = time.time()
        filtered = rs_filter_reads(reads, quals)
        phase["rs_decode"] = time.time() - t0
        n_kept = len(filtered.payloads)

        t0 = time.time()
        llr_sub: dict = {}
        llr_table = compute_trial_llrs(
            filtered, config.epsil, aligner, timings=llr_sub
        )  # [18432, 272]
        soft = llr_table.T.copy()  # [272, 18432] per-codeword soft inputs
        phase["llr"] = time.time() - t0
        for k, v in llr_sub.items():
            phase[f"llr_{k}"] = v
        if checkpoint_path:
            TrialCheckpoint(
                epsil=config.epsil, llr_table=llr_table, n_reads_kept=n_kept
            ).save(checkpoint_path)

    resume = None
    if ckpt is not None and ckpt.decoded_bits is not None and ckpt.fail_current is not None:
        resume = (
            ckpt.decoded_bits,
            [int(i) for i in (ckpt.fail_first if ckpt.fail_first is not None else [])],
            [int(i) for i in ckpt.fail_current],
            ckpt.anneal_iters,
        )

    save_cb = None
    if checkpoint_path:
        def save_cb(dec_now, ff, fc, iters):
            TrialCheckpoint(
                epsil=config.epsil,
                llr_table=llr_table,
                decoded_bits=np.asarray(dec_now, np.uint8),
                fail_first=np.asarray(ff, np.int64),
                fail_current=np.asarray(fc, np.int64),
                anneal_iters=iters,
                n_reads_kept=n_kept,
            ).save(checkpoint_path)

    dec, fail_first, fail, n_iters = anneal_decode(
        graph, soft, codewords, config, phase, resume=resume, save_cb=save_cb
    )

    hard = (soft < 0).astype(np.uint8)  # LLR >= 0 -> 0 (decoder.py:565-571)
    re_decode = (dec != hard).sum(axis=0)  # [18432] per-strand flip counts
    n_erasure = int((re_decode > ERASURE_THRESHOLD).sum())

    return TrialResult(
        success=not fail,
        fail_first=fail_first,
        fail_final=fail,
        n_anneal_iters=n_iters,
        n_erasure_strands=n_erasure,
        decoded_bits=dec,
        total_time=time.time() - t_start,
        phase_times=phase,
        n_reads_kept=n_kept,
    )
