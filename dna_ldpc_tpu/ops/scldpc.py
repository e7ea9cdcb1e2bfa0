"""Sliding-window and pipeline decoding of spatially-coupled LDPC chains.

Batched re-design of the reference's windowed decoder family
(``LDPC_dec/ldpc/dec.cpp``: Run_SW_Decoder and the ~10 windowed BEC
variants, dec.cpp:243-580; pipeline decoder for SC-LDPC chains,
dec.cpp:1910+; windowed syndrome helpers ``check_bound``/
``mod2sparse_mulvec_bound``, check.cpp:49-72 / mod2sparse.h:167).

The chain's band structure (models/scldpc.py) makes every interior window
structurally identical, so ONE window graph is compiled and reused for
every window position — the decoding wave is a host loop over window
anchors, each step a batched BP (or BEC peel) on [batch, window] arrays:

- window variables: w frozen (already-decided) blocks + W active blocks;
- decided blocks enter as saturated +/-BIG LLRs (the "hard decision
  feedback" of windowed decoding);
- after ``iters`` BP iterations the oldest active block commits its hard
  decisions and the window slides one position.

The reference's pipeline decoder keeps several windows in flight at once
(one per frame stage); here the same concurrency is the batch axis —
every batch element advances through the same window anchor together, so
a batch of F frames is exactly an F-deep decoding pipeline.
"""

from __future__ import annotations

import functools

import numpy as np

from ..models.ldpc_graph import LdpcGraph
from ..models.scldpc import ScChain
from ..utils.io_formats import SparseBinaryMatrix
from .bp import bp_decode
from .decoders import ERASE_MARK

BIG = 1e9  # saturated LLR for decided/terminated variables


@functools.lru_cache(maxsize=None)
def _window_graph(chain: ScChain, W: int) -> LdpcGraph:
    """The (periodic) window subgraph: variable blocks t0-w..t0+W-1 and
    check blocks t0..t0+W-1, sliced at an interior anchor. All interior
    windows share this structure because couple() uses one edge-spreading
    for every position."""
    w, b_v, b_c = chain.w, chain.b_v, chain.b_c
    if chain.L < W + w:
        raise ValueError("chain too short for this window")
    t0 = w  # guaranteed interior anchor
    dense = chain.H.to_dense()
    rows = dense[t0 * b_c : (t0 + W) * b_c, (t0 - w) * b_v : (t0 + W) * b_v]
    sub = SparseBinaryMatrix.from_coo(
        rows.shape[0], rows.shape[1], *np.nonzero(rows)
    )
    return LdpcGraph.from_sparse(sub)


def sliding_window_decode(
    chain: ScChain,
    llr,
    W: int = 4,
    iters: int = 20,
) -> np.ndarray:
    """Sliding-window BP over an SC-LDPC chain. llr: [B, n_vars] float32.
    Returns hard decisions [B, n_vars] uint8, committed block by block as
    the window slides (the decoding wave)."""
    import jax.numpy as jnp

    llr = np.atleast_2d(np.asarray(llr, np.float32))
    B = llr.shape[0]
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)

    # pad: w decided-zero blocks on the left, W-1 terminated blocks right
    pad_l = np.full((B, w * b_v), BIG, np.float32)
    pad_r = np.full((B, (W - 1) * b_v), BIG, np.float32)
    work = np.concatenate([pad_l, llr, pad_r], axis=1)
    bits = np.zeros((B, L * b_v), np.uint8)

    for t0 in range(L):
        lo = t0 * b_v  # window starts at (t0 - w) + w pad blocks
        win = work[:, lo : lo + (W + w) * b_v]
        res = bp_decode(graph, jnp.asarray(win), max_iter=iters)
        dec = np.asarray(res.bits)[:, w * b_v : (w + 1) * b_v]  # oldest active
        bits[:, t0 * b_v : (t0 + 1) * b_v] = dec
        # hard-decision feedback: freeze the committed block
        work[:, (t0 + w) * b_v : (t0 + w + 1) * b_v] = np.where(dec == 0, BIG, -BIG)
    return bits


def pipeline_decode(chain: ScChain, llrs, W: int = 4, iters: int = 20) -> np.ndarray:
    """TRUE pipelined schedule over many frames (the reference's
    multi-window pipeline decoder for SC-LDPC streams, dec.cpp:1910+):
    frame f enters the pipe at tick f, and at tick t every in-flight
    frame f advances its window at position t - f — so up to F windows
    (one per pipeline stage) decode CONCURRENTLY as one batched BP on
    the shared window graph, each batch row sliced at its own anchor.

    Produces exactly sliding_window_decode's output per frame (the
    window recursions are independent across frames); the staging is the
    concurrency structure the reference gets from keeping one window per
    stream position in flight."""
    import jax.numpy as jnp

    llrs = np.atleast_2d(np.asarray(llrs, np.float32))
    F = llrs.shape[0]
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    win_n = (W + w) * b_v

    pad_l = np.full((F, w * b_v), BIG, np.float32)
    pad_r = np.full((F, (W - 1) * b_v), BIG, np.float32)
    work = np.concatenate([pad_l, llrs, pad_r], axis=1)
    bits = np.zeros((F, L * b_v), np.uint8)

    for t in range(L + F - 1):
        active = [f for f in range(F) if 0 <= t - f < L]
        # one batched window decode across all pipeline stages: row k is
        # frame active[k]'s window at its own anchor; the batch is padded
        # to F rows (pipe fill/drain) so one compiled decoder serves
        # every tick
        win = np.full((F, win_n), BIG, np.float32)
        for k, f in enumerate(active):
            win[k] = work[f, (t - f) * b_v : (t - f) * b_v + win_n]
        res = bp_decode(graph, jnp.asarray(win), max_iter=iters)
        dec_all = np.asarray(res.bits)[:, w * b_v : (w + 1) * b_v]
        for k, f in enumerate(active):
            t0 = t - f
            dec = dec_all[k]
            bits[f, t0 * b_v : (t0 + 1) * b_v] = dec
            work[f, (t0 + w) * b_v : (t0 + w + 1) * b_v] = np.where(
                dec == 0, BIG, -BIG
            )
    return bits


def sliding_window_bec(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
) -> np.ndarray:
    """Windowed BEC peeling: values [B, n_vars] int8 with 0/1 known and
    2 = erased. Returns [B, n_vars] int8 (2 where a window failed to
    resolve, matching the reference's ERASE_MARK convention).

    Variant note: the reference ships ~10 windowed-BEC variants
    (``DECODER_BEC_SW`` .. ``DECODER_BEC_SW_OPTION``, DNA_main.cpp:59-67;
    dec.cpp:243-580). This function is the BASE ``DECODER_BEC_SW``
    recursion: a width-(W+w) window slides one block per step, peels to
    completion (up to ``iters`` rounds), writes every newly-resolved
    erasure back into the shared value array (so the resolution wave
    feeds later windows, as the reference's in-place mod2sparse updates
    do), and commits the oldest block before advancing. The
    scheduling-distinct variants are implemented below:
    ``sliding_window_bec_save`` (_SAVE: per-position erasure-rate
    bookkeeping), ``sliding_window_bec_two`` (_TWO: mirrored
    bidirectional sweeps), ``sliding_window_bec_two_cross`` (_TWO_CROSS:
    both waves sweep the FULL chain), ``sliding_window_bec_two_indi``
    (_TWO_INDI: independent wave states, stitched halves),
    ``sliding_window_bec_step`` (_STEP: stride-eta advance),
    ``sliding_window_bec_ra`` (_RA: lockstep dual windows over a
    repeat-accumulate layout), ``sliding_window_bec_oc`` (_OC: eta
    concurrent segment waves, batched on the batch axis),
    ``sliding_window_bec_target`` (_TARGET: first-window probe), and the
    non-windowed ``bec_decode_save`` / ``bec_decode_target``
    (DECODER_BEC_SAVE/_TARGET). ``DECODER_BEC_SW_OPTION`` (enum 98) has
    config parsing but NO decoder dispatch or body anywhere in the
    reference (DNA_main.cpp:480-490 reads a _order.txt file — into the
    punctuation array, a latent bug — and LDPC_Decode has no OPTION
    branch), so there is no behavior to reproduce."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)

    pad_l = np.zeros((B, w * b_v), np.int8)
    pad_r = np.zeros((B, (W - 1) * b_v), np.int8)
    work = np.concatenate([pad_l, values, pad_r], axis=1)
    out = np.full((B, L * b_v), ERASE_MARK, np.int8)

    for t0 in range(L):
        lo = t0 * b_v
        win = work[:, lo : lo + (W + w) * b_v]
        # peel the window; write back every newly-resolved erasure (the
        # wave feeds later windows) and commit the oldest block
        still = np.asarray(_peel_values(graph, win, iters))
        work[:, lo : lo + (W + w) * b_v] = still
        out[:, t0 * b_v : (t0 + 1) * b_v] = still[:, w * b_v : (w + 1) * b_v]
    return out


def _peel_values(graph: LdpcGraph, win, iters):
    """BEC peel returning the value array (bits where resolved, 2 where
    not) rather than BpResult's zero-filled bits."""
    import jax.numpy as jnp

    return _peel_values_jit(graph, iters)(jnp.asarray(win, jnp.int8))


@functools.lru_cache(maxsize=None)
def _peel_values_jit(graph: LdpcGraph, iters: int):
    import jax
    import jax.numpy as jnp

    tables = graph.device_tables()
    check_vars = tables["check_vars"]
    check_mask = tables["check_mask"]
    M, N = graph.n_checks, graph.n_vars
    dc = graph.dc_max

    def peel(vals):
        B = vals.shape[0]
        gather_idx = jnp.maximum(check_vars, 0).reshape(-1)

        def cond(state):
            n, _, changed = state
            return (n < iters) & changed

        def body(state):
            n, vals, _ = state
            g = jnp.take(vals, gather_idx, axis=1).reshape(B, M, dc)
            g = jnp.where(check_mask[None], g, 0)
            erased = g == ERASE_MARK
            n_erased = jnp.sum(erased, axis=-1)
            known_parity = jnp.sum(jnp.where(erased, 0, g), axis=-1) % 2
            solvable = n_erased == 1
            var_of = jnp.sum(jnp.where(erased, jnp.maximum(check_vars, 0)[None], 0), axis=-1)
            target = jnp.where(solvable, var_of, N)
            upd = jnp.full((B, N + 1), ERASE_MARK, jnp.int8)
            upd = upd.at[jnp.arange(B)[:, None], target].set(known_parity.astype(jnp.int8))
            new_vals = jnp.where(
                (vals == ERASE_MARK) & (upd[:, :N] != ERASE_MARK), upd[:, :N], vals
            )
            return (n + 1, new_vals, jnp.any(new_vals != vals))

        _, vals, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), vals, jnp.bool_(True)))
        return vals

    return jax.jit(peel)


# ---------------------------------------------------------------------------
# Windowed-BEC variant family (DNA_main.cpp:59-67; dec.cpp:2677-3700)
# ---------------------------------------------------------------------------


def sliding_window_bec_save(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
):
    """``DECODER_BEC_SW_SAVE`` (dec.cpp Run_BEC_SW_Decoder_SAVE): the base
    recursion plus per-position erasure-rate bookkeeping — the
    ``test_BER(0/1, ...)`` hooks record, for every committed block, the
    fraction of erased bits immediately BEFORE and AFTER its window's
    peel (the columns of the reference's ``position_BER`` dump,
    DNA_main.cpp POSITION_BER_ files).

    Returns (bits, stats [L, 2] float64: mean erased fraction in the
    commit block before / after peeling, averaged over the batch)."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)

    pad_l = np.zeros((B, w * b_v), np.int8)
    pad_r = np.zeros((B, (W - 1) * b_v), np.int8)
    work = np.concatenate([pad_l, values, pad_r], axis=1)
    out = np.full((B, L * b_v), ERASE_MARK, np.int8)
    stats = np.zeros((L, 2), np.float64)

    for t0 in range(L):
        lo = t0 * b_v
        commit = slice(lo + w * b_v, lo + (w + 1) * b_v)
        stats[t0, 0] = (work[:, commit] == ERASE_MARK).mean()
        win = work[:, lo : lo + (W + w) * b_v]
        still = np.asarray(_peel_values(graph, win, iters))
        work[:, lo : lo + (W + w) * b_v] = still
        stats[t0, 1] = (work[:, commit] == ERASE_MARK).mean()
        out[:, t0 * b_v : (t0 + 1) * b_v] = still[:, w * b_v : (w + 1) * b_v]
    return out, stats


def _two_wave_work(chain: ScChain, values, W: int):
    """Padded work array shared by the _TWO family: w known-zero blocks
    left (left termination) and W-1+w known-zero blocks right — the
    right pad stands in for BOTH the right termination checks' missing
    variables and the beyond-end windows of the full-length _CROSS
    sweep (a known-0 pad variable is exactly equivalent to a shorter
    check row on the BEC: it contributes no parity and no erasure)."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    w, b_v = chain.w, chain.b_v
    pad_l = np.zeros((B, w * b_v), np.int8)
    pad_r = np.zeros((B, (W - 1 + w) * b_v), np.int8)
    return np.concatenate([pad_l, values, pad_r], axis=1), B


def sliding_window_bec_two(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
) -> np.ndarray:
    """``DECODER_BEC_SW_TWO`` (dec.cpp:2900-3007 Run_BEC_SW_Decoder_Two):
    TWO windows sweep simultaneously — one forward from the left end,
    one backward from the right end — sharing the value array, so the
    two resolution waves meet in the middle after SC_Ls = L/2 steps
    each.

    The backward window is the INDEX REFLECTION of the forward one
    (dec.cpp:2972-2977: V2 = [N-V_End, N-V_Start), C2 = [M-C_End,
    M-C_Start)): at step t its checks are blocks [L+w-t-W, L+w-t) — its
    first step therefore anchors on the TERMINATION checks [L, L+w),
    which is what lets it peel a right-anchored erasure run the forward
    sweep strands (the r4 advisor's counter-example). The window
    subgraph itself is shared (checks [c0, c0+W) always read vars
    [c0-w, c0+W)); only the anchor mirrors.
    """
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    work, B = _two_wave_work(chain, values, W)
    win_n = (W + w) * b_v

    for t in range(max(1, L // 2)):
        # forward window: checks [t, t+W), vars [t-w, t+W)
        lo = t * b_v
        still = np.asarray(_peel_values(graph, work[:, lo : lo + win_n], iters))
        work[:, lo : lo + win_n] = still

        # backward window: checks [L+w-t-W, L+w-t), vars [L-t-W, L-t+w)
        # — work offset of var block b is (b+w)*b_v, so the window
        # starts at block L-t-W (clamped at the left end for very wide
        # windows, where the reference's reflected V_Start2 goes
        # negative)
        lo2 = max(0, L - t - W + w) * b_v
        still2 = np.asarray(_peel_values(graph, work[:, lo2 : lo2 + win_n], iters))
        work[:, lo2 : lo2 + win_n] = still2

    # the reference's _Two writes decisions into dblk in place and the
    # final dblk is the output (no commit snapshots) — mirror that
    return work[:, w * b_v : (w + L) * b_v].copy()


def sliding_window_bec_two_cross(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
) -> np.ndarray:
    """``DECODER_BEC_SW_TWO_CROSS`` (dec.cpp:3009-3121): identical to
    ``sliding_window_bec_two`` except the two waves do NOT stop at the
    middle — the step loop runs t = 0..L-1 with the window ranges
    clamped at the chain ends (dec.cpp:3090-3093), so each wave sweeps
    the ENTIRE chain and crosses the other.  An erasure pattern that
    needs context from the far half (e.g. a left-half run only peelable
    right-to-left) resolves here but not under _TWO."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    work, B = _two_wave_work(chain, values, W)
    win_n = (W + w) * b_v

    for t in range(L):
        lo = t * b_v
        still = np.asarray(_peel_values(graph, work[:, lo : lo + win_n], iters))
        work[:, lo : lo + win_n] = still

        lo2 = max(0, (L - t - W + w)) * b_v
        still2 = np.asarray(_peel_values(graph, work[:, lo2 : lo2 + win_n], iters))
        work[:, lo2 : lo2 + win_n] = still2

    return work[:, w * b_v : (w + L) * b_v].copy()


def sliding_window_bec_two_indi(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
) -> np.ndarray:
    """``DECODER_BEC_SW_TWO_INDI`` (dec.cpp:3123-3260): the two waves of
    _TWO run on INDEPENDENT decoder states (the reference copies H to H2
    and keeps a separate dblk2 for the backward wave, so the waves never
    exchange resolutions), and the output stitches the halves: variables
    [0, N/2) from the forward wave, [N/2, N) from the backward wave
    (dec.cpp:3243-3244).  A right-half erasure that only the FORWARD
    wave can resolve (left context) therefore stays erased here —
    distinguishing it from _TWO."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    N = chain.n_vars
    graph = _window_graph(chain, W)
    work_f, B = _two_wave_work(chain, values, W)
    work_b = work_f.copy()
    win_n = (W + w) * b_v

    for t in range(max(1, L // 2)):
        lo = t * b_v
        still = np.asarray(_peel_values(graph, work_f[:, lo : lo + win_n], iters))
        work_f[:, lo : lo + win_n] = still

        lo2 = max(0, L - t - W + w) * b_v
        still2 = np.asarray(_peel_values(graph, work_b[:, lo2 : lo2 + win_n], iters))
        work_b[:, lo2 : lo2 + win_n] = still2

    out = work_f[:, w * b_v : (w + L) * b_v].copy()
    out[:, N // 2 :] = work_b[:, w * b_v + N // 2 : w * b_v + N]
    return out


def sliding_window_bec_target(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
) -> np.ndarray:
    """``DECODER_BEC_SW_TARGET`` (dec.cpp:3394-3446): a first-window
    PROBE — the reference initializes and iterates exactly one window
    (checks [0, W), vars [0, W)) and returns; no sweep, no commit loop.
    Used to measure how far the first window's wave reaches.  Returns
    the value array after that single window peel (everything else
    untouched)."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)

    pad_l = np.zeros((B, w * b_v), np.int8)
    pad_r = np.zeros((B, (W - 1) * b_v), np.int8)
    work = np.concatenate([pad_l, values, pad_r], axis=1)
    win_n = (W + w) * b_v
    still = np.asarray(_peel_values(graph, work[:, :win_n], iters))
    work[:, :win_n] = still
    return work[:, w * b_v : (w + L) * b_v].copy()


def bec_decode_save(
    graph: LdpcGraph,
    values,
    block_sizes,
    max_rounds: int = 200,
):
    """``DECODER_BEC_SAVE`` (dec.cpp:378-460 Run_BEC_Decoder_SAVE):
    plain GLOBAL peeling (no window) instrumented with the position-BER
    trace — before the first round and after every round, the erased
    fraction of each spatial block is recorded (the reference's
    ``test_BER(n, ...)`` per Mv block, the columns of its
    POSITION_BER_ dumps), and the loop stops at stall (no change),
    success, or max_rounds.

    ``block_sizes``: per-block variable counts (the reference's Mv).
    Returns (values, trace [n_rounds+1, n_blocks] float64, n_rounds)."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    sizes = np.asarray(block_sizes, np.int64)
    edges = np.concatenate([[0], np.cumsum(sizes)])
    assert edges[-1] == graph.n_vars

    def blk_trace(vals):
        return [
            float((vals[:, edges[b] : edges[b + 1]] == ERASE_MARK).mean())
            for b in range(len(sizes))
        ]

    trace = [blk_trace(values)]
    vals = values
    n = 0
    for n in range(1, max_rounds + 1):
        new = np.asarray(_peel_values(graph, vals, 1))
        trace.append(blk_trace(new))
        if (new == vals).all():
            break
        vals = new
    return vals, np.asarray(trace), n


def bec_decode_target(
    graph: LdpcGraph,
    values,
    target: tuple[int, int],
    max_rounds: int = 200,
):
    """``DECODER_BEC_TARGET`` (dec.cpp:303-374 Run_BEC_Decoder_TARGET):
    global peeling with an EXTRA early exit — stop as soon as every
    variable in the 1-based inclusive ``target`` range [lo, hi] has
    decoded to ZERO (the reference simulates the all-zero codeword, so
    "target decoded to 0" means the watched span is recovered), in
    addition to the stall / clean-syndrome / max-round exits.

    Returns (values, n_rounds, target_clean)."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    lo, hi = target[0] - 1, target[1]  # 1-based inclusive, as the reference
    vals = values
    n = 0
    for n in range(1, max_rounds + 1):
        new = np.asarray(_peel_values(graph, vals, 1))
        stalled = (new == vals).all()
        vals = new
        if bool((vals[:, lo:hi] == 0).all()) or stalled:
            break
    return vals, n, bool((vals[:, lo:hi] == 0).all())


def sliding_window_bec_step(
    chain: ScChain,
    values,
    W: int = 4,
    eta: int = 2,
    iters: int = 50,
) -> np.ndarray:
    """``DECODER_BEC_SW_STEP`` (dec.cpp Run_BEC_SW_Decoder_Step): the
    window advances ``eta`` blocks per step and commits ``eta`` blocks at
    once — 1/eta as many window dispatches, at the cost of less look-ahead
    for the later blocks of each commit group (block t0+p sees only
    W-1-p blocks of right context instead of W-1). Requires eta <= W.
    eta=1 reduces to the base recursion."""
    if not 1 <= eta <= W:
        raise ValueError("need 1 <= eta <= W")
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)

    pad_l = np.zeros((B, w * b_v), np.int8)
    pad_r = np.zeros((B, (W - 1) * b_v), np.int8)
    work = np.concatenate([pad_l, values, pad_r], axis=1)
    out = np.full((B, L * b_v), ERASE_MARK, np.int8)

    for t0 in range(0, L, eta):
        lo = t0 * b_v
        still = np.asarray(_peel_values(graph, work[:, lo : lo + (W + w) * b_v], iters))
        work[:, lo : lo + (W + w) * b_v] = still
        hi = min(t0 + eta, L)
        out[:, t0 * b_v : hi * b_v] = still[:, w * b_v : (w + hi - t0) * b_v]
    return out


def ra_extend(chain: ScChain) -> SparseBinaryMatrix:
    """Repeat-accumulate extension of an SC chain: H_ra = [H | A] where A
    is the (L+w)*b_c-square dual-diagonal accumulator — check j gains
    parity variable p_j and (for j > 0) p_{j-1}. This is the variable
    layout the reference's ``DECODER_BEC_SW_RA`` decoder exists for
    (Run_BEC_SW_Decoder_RA, dec.cpp:3449-3576): systematic variables in
    the front segment, check-aligned accumulator parities in a tail
    segment starting at N1, windowed in lockstep by Mc-sized steps."""
    H = chain.H
    M = H.n_rows
    rows = np.repeat(np.arange(M), H.row_weights())
    cols = H.indices.copy()
    pr = np.concatenate([np.arange(M), np.arange(1, M)])
    pc = np.concatenate([np.arange(M), np.arange(M - 1)]) + H.n_cols
    return SparseBinaryMatrix.from_coo(
        M, H.n_cols + M, np.concatenate([rows, pr]), np.concatenate([cols, pc])
    )


@functools.lru_cache(maxsize=None)
def _ra_window_graph(chain: ScChain, W: int) -> LdpcGraph:
    """Window subgraph over BOTH segments: checks [a, a+W)*b_c, systematic
    vars [a-w, a+W)*b_v, parity vars [a-1, a+W)*b_c (the accumulator
    reaches one block left). Position-invariant for interior anchors."""
    w, b_v, b_c, L = chain.w, chain.b_v, chain.b_c, chain.L
    if L < W + w + 1:
        raise ValueError("chain too short for this window")
    H_ra = ra_extend(chain)
    dense = H_ra.to_dense()
    a = w + 1
    n_sys = chain.n_vars
    rows = dense[a * b_c : (a + W) * b_c]
    sys_cols = rows[:, (a - w) * b_v : (a + W) * b_v]
    par_cols = rows[:, n_sys + (a - 1) * b_c : n_sys + (a + W) * b_c]
    win = np.concatenate([sys_cols, par_cols], axis=1)
    sub = SparseBinaryMatrix.from_coo(win.shape[0], win.shape[1], *np.nonzero(win))
    return LdpcGraph.from_sparse(sub)


def sliding_window_bec_ra(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
) -> np.ndarray:
    """``DECODER_BEC_SW_RA`` (dec.cpp Run_BEC_SW_Decoder_RA): windowed BEC
    peeling for repeat-accumulate SC codes (``ra_extend``'s layout). Two
    windows advance in LOCKSTEP and are peeled JOINTLY each step
    (Iter_BEC_RA_SW_Decoder iterates both ranges inside one fixpoint
    loop): the systematic window over var blocks [t-w, t+W) and the
    parity window over the accumulator blocks [t-1, t+W) aligned with the
    window's checks — the reference's window-2 offsets advance by Mc[]
    amounts through the segment at N1 for exactly this reason
    (dec.cpp:3504-3556).

    ``values``: [B, n_vars + n_checks] int8 (systematic segment then
    parity segment; 2 = erased). Returns the same layout. A decoder
    without the lockstep parity window cannot decode this family at all:
    the accumulator columns live outside every systematic window, so
    their erasures are unresolvable and poison every check they touch."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    w, b_v, b_c, L = chain.w, chain.b_v, chain.b_c, chain.L
    n_sys = chain.n_vars
    Lc = L + w  # parity blocks
    graph = _ra_window_graph(chain, W)

    sys_vals = values[:, :n_sys]
    par_vals = values[:, n_sys:]
    assert par_vals.shape[1] == Lc * b_c

    pad_l = np.zeros((B, w * b_v), np.int8)
    pad_r = np.zeros((B, (W - 1) * b_v), np.int8)
    work_s = np.concatenate([pad_l, sys_vals, pad_r], axis=1)
    # parity: one known-0 block left (the accumulator's zero start);
    # right-pad to cover tail windows (same approximation as the
    # systematic right pad)
    ppad_l = np.zeros((B, b_c), np.int8)
    ppad_r = np.zeros((B, max(0, (W - 1) - w + 1) * b_c), np.int8)
    work_p = np.concatenate([ppad_l, par_vals, ppad_r], axis=1)

    out = np.full((B, n_sys + Lc * b_c), ERASE_MARK, np.int8)
    n_sys_win = (W + w) * b_v

    for t0 in range(L):
        lo_s = t0 * b_v                 # sys blocks [t0-w, t0+W)
        lo_p = t0 * b_c                 # parity blocks [t0-1, t0+W)
        win = np.concatenate(
            [work_s[:, lo_s : lo_s + n_sys_win],
             work_p[:, lo_p : lo_p + (W + 1) * b_c]],
            axis=1,
        )
        still = np.asarray(_peel_values(graph, win, iters))
        work_s[:, lo_s : lo_s + n_sys_win] = still[:, :n_sys_win]
        work_p[:, lo_p : lo_p + (W + 1) * b_c] = still[:, n_sys_win:]
        out[:, t0 * b_v : (t0 + 1) * b_v] = still[:, w * b_v : (w + 1) * b_v]
        out[:, n_sys + t0 * b_c : n_sys + (t0 + 1) * b_c] = still[
            :, n_sys_win + b_c : n_sys_win + 2 * b_c
        ]
    # tail parity blocks [L, L+w) commit from the final work state
    out[:, n_sys + L * b_c :] = work_p[:, (L + 1) * b_c : (Lc + 1) * b_c]
    return out


def sliding_window_bec_oc(
    chain: ScChain,
    values,
    W: int = 4,
    eta: int = 2,
    iters: int = 50,
) -> np.ndarray:
    """``DECODER_BEC_SW_OC`` (dec.cpp Run_BEC_SW_Decoder_OC): ``eta``
    windows sweep ``eta`` contiguous chain segments CONCURRENTLY — the
    reference keeps eta (V/C/D)_Start..End range sets and iterates each
    per step after a joint warm-up pass (dec.cpp:2804-2856). The decoding
    latency drops to ~L/eta window steps at the cost of each segment's
    head starting WITHOUT its left context (the previous segment's tail
    has not been decoded when the wave sets off).

    Batched mapping: the eta windows of one step share the window
    subgraph, so they peel as ONE batched call with windows stacked on
    the batch axis — the same trick that turns the reference's pipeline
    decoder into a batch (pipeline_decode). Requires segment length
    L//eta >= W + w so concurrent windows never overlap. Output follows
    the in-place dblk convention (final work-array state)."""
    values = np.atleast_2d(np.asarray(values, np.int8))
    B = values.shape[0]
    w, b_v, L = chain.w, chain.b_v, chain.L
    Ls = L // eta
    if Ls < W + w:
        raise ValueError("need L // eta >= W + w (non-overlapping windows)")
    graph = _window_graph(chain, W)
    win_n = (W + w) * b_v

    pad_l = np.zeros((B, w * b_v), np.int8)
    pad_r = np.zeros((B, (W - 1) * b_v), np.int8)
    work = np.concatenate([pad_l, values, pad_r], axis=1)

    def peel_anchors(anchors):
        """One batched peel of same-shaped windows at several anchors."""
        wins = np.concatenate(
            [work[:, a * b_v : a * b_v + win_n] for a in anchors], axis=0
        )
        still = np.asarray(_peel_values(graph, wins, iters))
        for k, a in enumerate(anchors):
            work[:, a * b_v : a * b_v + win_n] = still[k * B : (k + 1) * B]

    # joint warm-up: every segment head + the residual tail region
    # (Init_BEC_SW_Decoder calls + Iter_BEC_OC_Init_Decoder, dec.cpp:2824-2832)
    heads = [p * Ls for p in range(eta)]
    peel_anchors(heads)
    if eta * Ls < L:
        peel_anchors([min(eta * Ls, L - 1)])

    # eta concurrent waves, one batched peel per step
    for t in range(Ls):
        peel_anchors([p * Ls + t for p in range(eta)])
    # residual tail blocks (L not divisible by eta): the last wave carries on
    for t0 in range(eta * Ls, L):
        peel_anchors([t0])

    out = np.full((B, L * b_v), ERASE_MARK, np.int8)
    out[:] = work[:, w * b_v : (w + L) * b_v]
    return out
