"""Batched Levenshtein edit distance via antidiagonal dynamic programming.

Replaces the reference's per-pair O(L^2) Python DP (``ex_decoder/
def_func.py:10-26``, called all-pairs inside every mixed-length cluster,
decoder.py:179-187) with one vectorized computation over *all* pairs of a
trial at once: the DP table is swept by antidiagonals, so each of the
L1+L2 steps is an elementwise min over a [n_pairs, diag] slab — numpy on
host (the pipeline's ingest stage), with identical results to the scalar
recurrence (substitution/insert/delete all cost 1).
"""

from __future__ import annotations

import numpy as np


def edit_distance_pairs(
    seqs: np.ndarray, lengths: np.ndarray, pairs_a: np.ndarray, pairs_b: np.ndarray
) -> np.ndarray:
    """Edit distances for specified sequence pairs.

    seqs: [n, Lmax] uint8 padded byte matrix; lengths: [n]; pairs_a/b: [P]
    row indices. Returns [P] int32 distances between the unpadded strings.
    """
    if len(pairs_a) == 0:
        return np.zeros(0, dtype=np.int32)
    A = seqs[pairs_a]
    B = seqs[pairs_b]
    la = lengths[pairs_a].astype(np.int64)
    lb = lengths[pairs_b].astype(np.int64)
    P, L = A.shape
    if L == 0:
        return np.zeros(P, dtype=np.int32)

    # dp has (L+1) x (L+1) conceptual cells per pair; we keep two previous
    # antidiagonals. Cell (i, j) = distance between A[:i], B[:j].
    # Antidiagonal d holds cells with i + j = d, i in [max(0,d-L), min(d,L)].
    INF = np.int32(1 << 20)
    maxd = 2 * L
    # prev2 = diag d-2, prev1 = diag d-1, indexed by i (row coordinate)
    prev2 = np.full((P, L + 1), INF, dtype=np.int32)
    prev1 = np.full((P, L + 1), INF, dtype=np.int32)
    prev1[:, 0] = 1  # (0,1)
    prev1[:, 1] = 1  # (1,0)
    prev2[:, 0] = 0  # (0,0)
    dists = np.zeros(P, dtype=np.int32)
    # record boundary results when (i, j) == (la, lb), i.e. d == la + lb
    done_d = la + lb
    dists[done_d == 0] = 0
    dists[done_d == 1] = 1  # one string empty, the other length 1

    i_all = np.arange(L + 1)
    for d in range(2, maxd + 1):
        cur = np.full((P, L + 1), INF, dtype=np.int32)
        i_lo, i_hi = max(0, d - L), min(d, L)
        i = i_all[i_lo : i_hi + 1]
        j = d - i
        # deletion (i-1, j) lives on prev1 at i-1; insertion (i, j-1) on
        # prev1 at i; substitution/match (i-1, j-1) on prev2 at i-1.
        del_ = np.where(i[None, :] >= 1, prev1[:, np.maximum(i - 1, 0)], INF)
        ins_ = prev1[:, i]
        sub_ = np.where(i[None, :] >= 1, prev2[:, np.maximum(i - 1, 0)], INF)
        # character comparison for (i, j): A[i-1] vs B[j-1]; valid when
        # 1 <= i <= la and 1 <= j <= lb (outside, cells are unused)
        ai = np.take_along_axis(A, np.maximum(i - 1, 0)[None, :].repeat(P, 0), axis=1)
        bj = np.take_along_axis(B, np.maximum(j - 1, 0)[None, :].repeat(P, 0), axis=1)
        eq = ai == bj
        cost = np.minimum(np.minimum(del_, ins_), sub_) + 1
        cost = np.where(eq & (i[None, :] >= 1) & (j[None, :] >= 1), np.minimum(cost, sub_), cost)
        # boundary rows/cols of the DP table
        cur[:, i_lo : i_hi + 1] = cost
        if d <= L:
            cur[:, 0] = d   # (0, d)
            cur[:, d] = d   # (d, 0)
        hit = done_d == d
        if hit.any():
            dists[hit] = cur[hit, la[hit]]
        prev2, prev1 = prev1, cur
        if d >= done_d.max():
            break
    return dists


def _edit_pairs_device_impl(seqs, lens, pa, pb):
    """Antidiagonal edit-distance DP as one jitted program (all pairs of
    a trial in a single dispatch; the pair gathers happen in-program so
    every op shares one compiled executable).  Same recurrence and cell
    layout as the numpy sweep above; distances are integers, so results
    are bit-identical."""
    import jax
    import jax.numpy as jnp

    A = jnp.take(seqs, pa, axis=0)
    B = jnp.take(seqs, pb, axis=0)
    la = jnp.take(lens, pa)
    lb = jnp.take(lens, pb)
    P, L = A.shape
    INF = jnp.int32(1 << 20)
    lane = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    # ai[p, i] = A[p, i-1] (constant across diagonals)
    ai = jnp.concatenate([jnp.zeros((P, 1), A.dtype), A], axis=1)
    done_d = (la + lb).astype(jnp.int32)

    def shr(x):
        return jnp.concatenate([jnp.full((P, 1), INF), x[:, :-1]], axis=1)

    def body(carry, d):
        prev2, prev1, yd, dist = carry
        # yd[p, i] = B[p, d-1-i]: one roll + a dynamic column insert
        bcol = jax.lax.dynamic_slice_in_dim(B, jnp.minimum(d - 1, L - 1), 1, axis=1)
        yd = jnp.where(lane == 0, bcol, jnp.roll(yd, 1, axis=1))
        j = d - lane
        del_ = shr(prev1)
        ins_ = prev1
        sub_ = shr(prev2)
        eq = (ai == yd) & (lane >= 1) & (j >= 1)
        cost = jnp.minimum(jnp.minimum(del_, ins_), sub_) + 1
        cost = jnp.where(eq, jnp.minimum(cost, sub_), cost)
        dle = d <= L
        cost = jnp.where((lane == 0) & dle, d, cost)
        cost = jnp.where((lane == d) & dle, d, cost)
        cost = jnp.where(j < 0, INF, cost)
        hit = done_d == d
        cell = jnp.sum(jnp.where(lane == la[:, None], cost, 0), axis=1)
        dist = jnp.where(hit, cell, dist)
        return (prev1, cost, yd, dist), None

    prev2 = jnp.full((P, L + 1), INF).at[:, 0].set(0)
    prev1 = jnp.full((P, L + 1), INF).at[:, 0].set(1).at[:, 1].set(1)
    yd0 = jnp.where(lane == 0, B[:, :1].astype(jnp.int32), 0).astype(A.dtype)
    dist0 = jnp.where(done_d <= 1, done_d, 0)
    (_, _, _, dist), _ = jax.lax.scan(
        body, (prev2, prev1, yd0, dist0), jnp.arange(2, 2 * L + 1, dtype=jnp.int32)
    )
    return dist


_EDIT_JIT = None  # module-level jit wrapper (one trace cache per process)


def edit_distance_pairs_device(
    seqs: np.ndarray, lengths: np.ndarray, pairs_a: np.ndarray,
    pairs_b: np.ndarray, min_pairs: int = 4096, min_reads: int = 4096,
) -> np.ndarray:
    """Device path for the trial-wide edit-distance pre-filter: ships the
    (deduplicated) read byte matrix + pair index lists to the device and
    runs every pair's DP in ONE dispatch — the upload is ~1.5 MB where
    shipping per-pair matrices would be ~13 MB. The pair AND read axes
    pad to power-of-two buckets so a trial reuses a handful of compiled
    shapes (every eager op with a trial-varying shape would recompile).
    Bit-identical to edit_distance_pairs (integer DP)."""
    import jax
    import jax.numpy as jnp

    global _EDIT_JIT
    if _EDIT_JIT is None:
        _EDIT_JIT = jax.jit(_edit_pairs_device_impl)

    P = len(pairs_a)
    if P == 0:
        return np.zeros(0, dtype=np.int32)

    n, L = seqs.shape
    # callers with a known workload scale pass min_pairs/min_reads at
    # their steady-state size so every trial reuses ONE compiled shape
    # (each new bucket costs a full scan compile)
    nb = max(min_reads, 1 << int(np.ceil(np.log2(n))))
    Pb = max(min_pairs, 1 << int(np.ceil(np.log2(P))))
    seqs_p = np.zeros((nb, L), seqs.dtype)
    seqs_p[:n] = seqs
    lens_p = np.zeros(nb, np.int32)
    lens_p[:n] = lengths
    pa = np.zeros(Pb, np.int32)
    pb = np.zeros(Pb, np.int32)
    pa[:P] = pairs_a
    pb[:P] = pairs_b
    dist = _EDIT_JIT(
        jnp.asarray(seqs_p), jnp.asarray(lens_p), jnp.asarray(pa), jnp.asarray(pb)
    )
    return np.asarray(dist)[:P].astype(np.int32)


def edit_distance(s1: str, s2: str) -> int:
    """Scalar convenience wrapper (test parity with def_func.edit_dist)."""
    from ..utils.dna import seqs_to_matrix

    mat = seqs_to_matrix([s1, s2], fill=b"\x00")
    lengths = np.array([len(s1), len(s2)])
    return int(
        edit_distance_pairs(mat, lengths, np.array([0]), np.array([1]))[0]
    )
