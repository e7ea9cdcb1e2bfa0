"""Device-resident batched progressive alignment + iterative refinement.

The fused flow computes pair posteriors and the consistency transform
on device, then DOWNLOADS the top-k sparse transport (~380 MB/trial) to
run MUSCLE's ProgressiveAlign/RefineIter stages in host C++
(native/ingest.cpp).  This module keeps the posteriors ON DEVICE end to
end: the progressive joins and refinement re-alignments of EVERY
cluster run as batched XLA programs, and only the final column maps
(~2 MB/trial of uint8) are downloaded.

Reference semantics implemented (MUSCLE v5, vendored in the reference):

- ``MPCFlat::ProgressiveAlign`` / ``ProgAln`` (progalnflat.cpp:41-100):
  merge profiles pairwise along the UPGMA join order;
- ``BuildPost`` (buildpostflat.cpp:18-100): profile-profile posterior
  P[c1, c2] = sum over (s1 in A, s2 in B) of the pair posterior at the
  letter positions mapped to columns c1/c2;
- ``CalcAlnFlat`` + ``TraceBackFlat`` (calcalnflat.cpp/tracebackflat.cpp):
  MEA max-DP with tie preference B >= X >= Y (best3.h argument order),
  boundary rows/cols fixed to X/Y;
- ``AlignAlns`` (alnalnsflat.cpp:7-44): gap insertion along the path;
- ``MPCFlat::Refine`` / ``RefineIter`` (refineflat.cpp:4-31,
  mpcflat.cpp:257-267): seeded random bipartitions, re-align the two
  projected sub-MSAs (``MultiSequence::Project`` drops all-gap columns);
  this build's converge-after-5 early stop (the documented deviation
  from the fixed 100 iterations) is reproduced exactly: a cluster
  freezes after 5 consecutive no-change iterations.

Representation: per cluster c and sequence s, ``cpos[c, s, u]`` holds
the letter position of s at column u of s's CURRENT profile, or the
sentinel L for a gap.  All per-merge machinery is uniform in this
representation:

- projection = compact the columns where any selected row has a letter
  (a cumsum + two gathers); for progressive merges the operands are
  already compact so this is the identity;
- BuildPost = ``EA @ Pblock @ EB^T``: the cluster's pair posteriors are
  arranged ONCE per super-batch as a symmetric per-sequence block
  matrix (build_pblock), and each merge builds one-hot (side-masked)
  column->position expansion matrices and runs two large batched
  matmuls instead of per-pair gathers;
- the MEA DP runs over antidiagonals (one [C, W] slab per step,
  lax.scan, operands streamed from a pad+reshape "skew trick" plane —
  no gathers) emitting a per-cell choice-code plane, and the traceback
  is a reverse scan walking one cell per diagonal — every step is a
  full vector op over the cluster batch;
- gap insertion = remap cpos through the path's column maps (cumsum +
  scatter + gather).

Exactness: the MEA recurrence, tie preference, boundary codes,
projection, and convergence rule match the host path (ops/msa/align.py
+ native/ingest.cpp) operation for operation.  Two divergences, both
confined to BuildPost: float summation ORDER (the host sums
profile-row pairs in row order, the device contracts over the block
axis) and bf16 matmul input rounding (~2^-9 relative; the one-hot
operands are exact).  Either can flip exact-tie traceback choices when
>= 3 reads overlap a cell; clusters of 2 sequences see a single pair
and no near-ties in practice.  Per-cluster outputs match the host
aligner exactly on the seeded test workloads, and end-to-end trial
outcomes are parity-tested (tests/test_device_msa.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

CB, CX, CY = 1, 2, 3          # path step codes ('B', 'X', 'Y'); 0 = none
NEG = np.float32(-3.0e38)

# cluster-size buckets for the device MSA programs (fewer than the
# consistency N_BUCKETS: each bucket compiles its own merge scans —
# compiles are expensive — so n pads up
# to the next bucket; zero pair blocks and all-false masks make pad
# slots inert. 12 exists for the double-coverage regime, where n=9..12
# clusters dominate and the jump to npair=120 would cost 2-3x padding)
MSA_BUCKETS = (2, 4, 8, 12, 16, 32)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Host-side schedule construction
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def refine_mask_table(n: int, refine_iters: int = 100, seed: int = 0) -> np.ndarray:
    """The bipartition mask sequence a cluster of n sequences consumes:
    numpy Generator draws identical to align()'s host path (all-same
    rows removed, refineflat.cpp's rand()%2 -> seeded RNG here).
    Returns [n_valid, n] uint8."""
    if n < 3 or refine_iters <= 0:
        return np.zeros((0, n), np.uint8)
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 2, (refine_iters, n)).astype(np.uint8)
    keep = ~((masks.all(axis=1)) | (~masks.any(axis=1)))
    return masks[keep]


def wave_masks(joins: list[tuple[int, int]], n_true: int, nb: int):
    """Per-wave operand membership masks for one cluster's join order
    (node ids: leaves 0..n-1, internal n+k).  Returns (maskA, maskB):
    [nb-1, nb] bool, padded with all-false waves."""
    leaf: dict[int, np.ndarray] = {}
    for i in range(n_true):
        m = np.zeros(nb, bool)
        m[i] = True
        leaf[i] = m
    mA = np.zeros((nb - 1, nb), bool)
    mB = np.zeros((nb - 1, nb), bool)
    for k, (a, b) in enumerate(joins):
        mA[k] = leaf[a]
        mB[k] = leaf[b]
        leaf[n_true + k] = leaf.pop(a) | leaf.pop(b)
    return mA, mB


# ---------------------------------------------------------------------------
# The batched merge step (BuildPost + MEA DP + traceback + gap insertion)
# ---------------------------------------------------------------------------


def _project(cpos, mask, Cmax, L):
    """Compact the columns where any mask-selected row has a letter
    (MultiSequence::Project).  cpos: [C, nb, Cmax+1]; returns
    (cposS [C, nb, Cmax+1], w [C])."""
    C, nb, CP1 = cpos.shape
    occ = jnp.any(jnp.where(mask[:, :, None], cpos < L, False), axis=1)  # [C, CP1]
    occ = occ.at[:, Cmax].set(False)
    w = jnp.sum(occ, axis=1).astype(jnp.int32)
    t = jnp.cumsum(occ, axis=1) - 1
    tgt = jnp.where(occ, t, Cmax)  # dummy slot for dropped columns
    inv = jnp.full((C, CP1), Cmax, jnp.int32)
    inv = inv.at[jnp.arange(C)[:, None], tgt].set(
        jnp.broadcast_to(jnp.arange(CP1, dtype=jnp.int32)[None, :], (C, CP1))
    )
    inv = inv.at[:, Cmax].set(Cmax)  # sentinel slot: always the gap column
    cposS = jnp.take_along_axis(cpos, inv[:, None, :], axis=2)
    cposS = cposS.at[:, :, Cmax].set(L)
    return cposS, w


@functools.partial(jax.jit, static_argnums=(1,))
def build_pblock(P, nb):
    """One-time per super-batch: arrange the pair posteriors as the
    symmetric per-sequence block matrix
    ``Pblock[c, s1*(L+1)+l, s2*(L+1)+m]`` (zero diagonal blocks, lower
    triangle transposed), in bf16.  With this layout a profile-profile
    posterior is just ``EA @ Pblock @ EB^T`` for one-hot column->
    position matrices — two large batched matmuls per merge instead
    of per-pair gathers."""
    C, npair, L1, _ = P.shape
    ii, jj = np.triu_indices(nb, k=1)
    pid = np.full((nb, nb), npair, np.int32)  # npair = zero-pad slot
    for s, (a, b) in enumerate(zip(ii, jj)):
        pid[a, b] = s
        pid[b, a] = s
    Pz = jnp.concatenate([P, jnp.zeros((C, 1, L1, L1), P.dtype)], axis=1)
    full = jnp.take(Pz, jnp.asarray(pid.reshape(-1)), axis=1)
    full = full.reshape(C, nb, nb, L1, L1)
    lower = jnp.asarray((np.arange(nb)[:, None] > np.arange(nb)[None, :]))
    full = jnp.where(lower[None, :, :, None, None], jnp.swapaxes(full, 3, 4), full)
    full = full.astype(jnp.bfloat16)
    return jnp.transpose(full, (0, 1, 3, 2, 4)).reshape(C, nb * L1, nb * L1)


def _build_post(Pblock, cposA, cposB, mA, mB, Cmax, L):
    """Profile-profile posterior (BuildPost): [C, Cmax, Cmax] f32 as
    EA @ Pblock @ EB^T with one-hot (and side-masked) expansion
    matrices.  Inputs round to bf16 (one-hots are exact);
    the host path accumulates in f32 — a ~2^-9 relative divergence that
    only shows up at MEA near-ties (tests/test_device_msa.py measures
    outcome parity)."""
    C, nb, CP1 = cposA.shape
    L1 = L + 1
    l = jnp.arange(L1, dtype=jnp.int32)
    # EA[c, x, s*L1+l] = maskA[s] & (cposA[s, x] == l); gap sentinel L
    # hits the zero-padded row L of each block
    EA = (cposA[:, :, :Cmax, None] == l) & mA[:, :, None, None]
    EB = (cposB[:, :, :Cmax, None] == l) & mB[:, :, None, None]
    EA = jnp.transpose(EA, (0, 2, 1, 3)).reshape(C, Cmax, nb * L1).astype(jnp.bfloat16)
    EB = jnp.transpose(EB, (0, 2, 1, 3)).reshape(C, Cmax, nb * L1).astype(jnp.bfloat16)
    T = jnp.einsum("cxk,ckm->cxm", EA, Pblock, preferred_element_type=jnp.float32)
    return jnp.einsum(
        "cxm,cym->cxy", T.astype(jnp.bfloat16), EB,
        preferred_element_type=jnp.float32,
    )


def _skew_diagonals(post, Cmax):
    """Diagonal-layout view of the posterior WITHOUT gathers: the pad +
    reshape "skew trick".  Returns X [D, C, Cmax] f32 where
    X[d-1, c, v] = post[c, v, d - v - 2] (the operand the DP cell
    (i=v+1, j=d-i) on diagonal d consumes), zeros out of range."""
    C, V, W = post.shape
    A2 = jnp.pad(post, ((0, 0), (0, 0), (0, V + 1)))
    S = A2.reshape(C, V * (W + V + 1))[:, : V * (W + V)].reshape(C, V, W + V)
    # S[c, v, k] = post[c, v, k - v]; diag d needs k = d - 2
    X = jnp.moveaxis(S, 2, 0)                    # [W+V, C, V]
    D = 2 * Cmax
    return jnp.concatenate([jnp.zeros((1, C, V), post.dtype), X[: D - 1]], axis=0)


def _mea_forward(post, Cmax):
    """Antidiagonal MEA max-DP emitting the per-cell choice-code plane.
    post: [C, Cmax, Cmax] (cell (i, j) reads post[i-1, j-1]).  Returns
    cd: [D, C, W] uint8 for diagonals d = 1..D (W = Cmax + 1)."""
    C = post.shape[0]
    W = Cmax + 1
    D = 2 * Cmax
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    X = _skew_diagonals(post, Cmax)      # [D, C, Cmax], no per-step gathers

    def shr(a):  # value at lane-1 (NEG past the edge)
        return jnp.concatenate([jnp.full((C, 1), NEG), a[:, :-1]], axis=1)

    def body(carry, xs):
        prev2, prev1 = carry
        d, gd = xs
        j = d - lane
        postd = jnp.concatenate([jnp.zeros((C, 1), post.dtype), gd], axis=1)
        pB = shr(prev2) + postd
        pX = shr(prev1)
        pY = prev1
        # exact host tie order: B >= X ? (B >= Y ? B : Y) : (X >= Y ? X : Y)
        inner = jnp.where(pB >= pX, jnp.where(pB >= pY, pB, pY), jnp.where(pX >= pY, pX, pY))
        icode = jnp.where(
            pB >= pX,
            jnp.where(pB >= pY, CB, CY),
            jnp.where(pX >= pY, CX, CY),
        )
        b0 = lane == 0          # i == 0 -> 'Y' boundary, value 0
        bj = (j == 0) & (lane > 0)  # j == 0 -> 'X' boundary, value 0
        val = jnp.where(b0 | bj, 0.0, inner)
        code = jnp.where(b0, CY, jnp.where(bj, CX, icode))
        invalid = j < 0
        val = jnp.where(invalid, NEG, val)
        code = jnp.where(invalid, 0, code).astype(jnp.uint8)
        return (prev1, val), code

    p1_0 = jnp.where(lane == 0, 0.0, NEG) + jnp.zeros((C, W), jnp.float32)
    p2_0 = jnp.full((C, W), NEG)
    _, cd = jax.lax.scan(
        body, (p2_0, p1_0), (jnp.arange(1, D + 1, dtype=jnp.int32), X)
    )
    return cd


def _walk(cd, wA, wB, Cmax):
    """Reverse traceback walk over the choice plane.  Returns
    (codes [C, D] uint8, pos [C, D] int32) indexed by diagonal d-1,
    code 0 on diagonals the path skips.  The per-step read at the
    walker's lane uses a one-hot reduction (vector ops), not a gather."""
    C = wA.shape[0]
    W = Cmax + 1
    D = 2 * Cmax
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]

    def body(carry, xs):
        i_cur, d_cur = carry
        d, cdd = xs
        active = d_cur == d
        onehot = lane == i_cur[:, None]
        code = jnp.sum(jnp.where(onehot, cdd.astype(jnp.int32), 0), axis=1)
        code = jnp.where(active, code, 0)
        pos = jnp.where(active, i_cur, 0)
        step_ix = active & ((code == CB) | (code == CX))
        i_nxt = jnp.where(step_ix, i_cur - 1, i_cur)
        d_nxt = jnp.where(active, jnp.where(code == CB, d_cur - 2, d_cur - 1), d_cur)
        return (i_nxt, d_nxt), (code.astype(jnp.uint8), pos)

    init = (wA.astype(jnp.int32), (wA + wB).astype(jnp.int32))
    _, (codes, pos) = jax.lax.scan(
        body, init, (jnp.arange(1, D + 1, dtype=jnp.int32), cd), reverse=True
    )
    return jnp.swapaxes(codes, 0, 1), jnp.swapaxes(pos, 0, 1)


def _merge_step(Pblock, cpos, width, mA, mB, upd_ok, Cmax, L):
    """One batched merge (progressive wave or refine re-alignment).
    Returns (cpos', width', changed [C] bool, overflow_now [C] bool)."""
    C, nb, CP1 = cpos.shape
    dvec = jnp.arange(1, 2 * Cmax + 1, dtype=jnp.int32)[None, :]

    cposA, wA = _project(cpos, mA, Cmax, L)
    cposB, wB = _project(cpos, mB, Cmax, L)
    post = _build_post(Pblock, cposA, cposB, mA, mB, Cmax, L)
    cd = _mea_forward(post, Cmax)
    codes, pos = _walk(cd, wA, wB, Cmax)

    valid = codes != 0
    T = jnp.sum(valid, axis=1).astype(jnp.int32)
    overflow_now = T > Cmax
    t = jnp.cumsum(valid, axis=1) - 1
    isBX = (codes == CB) | (codes == CX)
    isBY = (codes == CB) | (codes == CY)
    cidx = jnp.arange(C)[:, None]
    tgtA = jnp.where(valid & isBX & (t < Cmax), t, Cmax)
    tgtB = jnp.where(valid & isBY & (t < Cmax), t, Cmax)
    amap = jnp.full((C, CP1), Cmax, jnp.int32)
    bmap = jnp.full((C, CP1), Cmax, jnp.int32)
    amap = amap.at[cidx, tgtA].set(pos - 1)
    bmap = bmap.at[cidx, tgtB].set((dvec - pos) - 1)
    amap = amap.at[:, Cmax].set(Cmax)
    bmap = bmap.at[:, Cmax].set(Cmax)
    amap = jnp.clip(amap, 0, Cmax)
    bmap = jnp.clip(bmap, 0, Cmax)

    newA = jnp.take_along_axis(cposA, amap[:, None, :], axis=2)
    newB = jnp.take_along_axis(cposB, bmap[:, None, :], axis=2)
    newcpos = jnp.where(
        mA[..., None], newA, jnp.where(mB[..., None], newB, cpos)
    )
    newcpos = newcpos.at[:, :, Cmax].set(L)
    inAB = mA | mB
    newwidth = jnp.where(inAB, T[:, None], width)

    changed = jnp.any(newcpos != cpos, axis=(1, 2)) | jnp.any(newwidth != width, axis=1)

    upd = upd_ok & jnp.any(mA, axis=1) & ~overflow_now
    cpos = jnp.where(upd[:, None, None], newcpos, cpos)
    width = jnp.where(upd[:, None], newwidth, width)
    return cpos, width, changed, overflow_now


# ---------------------------------------------------------------------------
# jitted batch programs
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2))
def _msa_init(lens, Cmax, L):
    """cpos0 [C, nb, Cmax+1] int32, width0 [C, nb] from sequence
    lengths (leaf profiles)."""
    C, nb = lens.shape
    u = jnp.arange(Cmax + 1, dtype=jnp.int32)[None, None, :]
    cpos = jnp.where(u < lens[:, :, None], u, L).astype(jnp.int32)
    return cpos, lens.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _msa_progressive(Pblock, cpos, width, jA, jB, Cmax, L, nb):
    """Run all progressive waves (jA/jB: [nwaves, C, nb] bool).
    Returns (cpos, width, overflow [C])."""
    C = cpos.shape[0]

    def body(carry, xs):
        cpos, width, ovf = carry
        mA, mB = xs
        cpos, width, _, ovf_now = _merge_step(
            Pblock, cpos, width, mA, mB, ~ovf, Cmax, L
        )
        ovf = ovf | (ovf_now & jnp.any(mA, axis=1))
        return (cpos, width, ovf), None

    ovf0 = jnp.zeros((C,), bool)
    (cpos, width, ovf), _ = jax.lax.scan(body, (cpos, width, ovf0), (jA, jB))
    return cpos, width, ovf


@functools.partial(jax.jit, static_argnums=(7, 8, 9))
def _msa_refine(Pblock, cpos, width, frozen, ovf, rA, rows_pc, Cmax, L, nb):
    """Run the refinement loop to convergence on device (rA: [iters, C,
    nb] bipartition masks, side B = complement over the true sequences;
    rows_pc: [C] per-cluster mask-table length).  A cluster freezes
    after 5 consecutive no-change iterations (the converge-after-5
    rule); the while_loop exits as soon as every cluster is frozen,
    overflowed, or out of mask rows — no host round trips."""
    C = cpos.shape[0]
    rows = rA.shape[0]

    def cond(st):
        it, cpos, width, unchanged, frozen, ovf = st
        live = ~(frozen | ovf) & (rows_pc > it)
        return (it < rows) & jnp.any(live)

    def body(st):
        it, cpos, width, unchanged, frozen, ovf = st
        mA = jax.lax.dynamic_index_in_dim(rA, it, 0, keepdims=False)
        has = jnp.any(cpos < L, axis=2)  # [C, nb]: real sequences
        mB = has & ~mA
        row_valid = jnp.any(mA, axis=1)
        upd_ok = ~frozen & ~ovf
        cpos, width, changed, ovf_now = _merge_step(
            Pblock, cpos, width, mA, mB, upd_ok, Cmax, L
        )
        ovf = ovf | (ovf_now & upd_ok & row_valid)
        act = row_valid & upd_ok
        unchanged = jnp.where(act, jnp.where(changed, 0, unchanged + 1), unchanged)
        frozen = frozen | (unchanged >= 5)
        return (it + 1, cpos, width, unchanged, frozen, ovf)

    unchanged = jnp.zeros((C,), jnp.int32)
    st = (jnp.int32(0), cpos, width, unchanged, frozen, ovf)
    st = jax.lax.while_loop(cond, body, st)
    _, cpos, width, unchanged, frozen, ovf = st
    return cpos, width, frozen, ovf


@jax.jit
def _msa_readout(cpos, width, ovf):
    """ONE packed uint8 download per batch (one host<->device sync):
    [C, nb*(Cmax+1) + 3] = flattened
    uint8 cpos (L <= 254), final width as 2 little-endian bytes (max
    over sequences; they share one node by now), overflow flag."""
    C = cpos.shape[0]
    w = jnp.max(width, axis=1)
    wlo = (w & 0xFF).astype(jnp.uint8)[:, None]
    whi = ((w >> 8) & 0xFF).astype(jnp.uint8)[:, None]
    return jnp.concatenate(
        [cpos.astype(jnp.uint8).reshape(C, -1), wlo, whi,
         ovf.astype(jnp.uint8)[:, None]],
        axis=1,
    )


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def assemble_transform(chunks, ids, mask, inv_n, nb, iters, C_cap, L):
    """Gather a super-batch's pair posteriors from its window of
    device-resident pair-HMM chunks (a FIXED-length tuple per bucket —
    every shape here is trial-independent, so each bucket compiles
    exactly one assemble program), bf16-round (the value set the host
    path's sparse transport would carry), and apply the consistency
    transform for buckets of >= 3 sequences.  ``ids`` are
    window-relative flat pair indices (mask covers pad slots).
    Returns [C_cap, npair, L+1, L+1] bf16 with zero-padded gap row/col
    (bf16 at rest: the only consumer is build_pblock, whose matmul
    operands are bf16 — and the transformed values feed BuildPost's
    bf16 matmul inputs either way)."""
    from .consistency import _consistency_core
    from .pairhmm import round_to_bf16

    npair = nb * (nb - 1) // 2
    W = jnp.concatenate(list(chunks), axis=0)
    sel = jnp.take(W, ids, axis=0)
    sel = jnp.where(mask[:, None, None], sel, 0.0)
    pm = round_to_bf16(sel).reshape(C_cap, npair, L, L)
    if iters and nb >= 3:
        # bf16 operands, f32 accumulation (relative error <= 2^-9 per
        # operand): BuildPost consumes bf16 operands, so f32 products buy
        # nothing downstream (see _consistency_core's docstring)
        op_dtype = jnp.bfloat16
        # chunk the block-matmul transform over clusters: its
        # [ck, nb, nb, L, L] intermediates are nb^2/npair times larger
        # than the pair tensor itself
        ck = max(1, (1 << 28) // (nb * nb * L * L * 8))
        while C_cap % ck and ck > 1:
            ck -= 1
        if C_cap > ck:
            pm = jax.lax.map(
                lambda args: _consistency_core(args[0], args[1], nb, iters, op_dtype),
                (
                    pm.reshape(C_cap // ck, ck, npair, L, L),
                    inv_n.reshape(C_cap // ck, ck),
                ),
            ).reshape(C_cap, npair, L, L)
        else:
            pm = _consistency_core(pm, inv_n, nb, iters, op_dtype)
    return jnp.pad(pm.astype(jnp.bfloat16), ((0, 0), (0, 0), (0, 1), (0, 1)))


# ---------------------------------------------------------------------------
# Batch driver
# ---------------------------------------------------------------------------


class MsaJob:
    """In-flight device MSA batch: all programs are dispatched, nothing
    is synced until :meth:`collect` — callers overlap the next batch's
    host-side work (joins, mask building) with this one's device
    compute."""

    def __init__(self, seqs_list, packed, nb, L):
        self._seqs = seqs_list
        self._packed = packed
        self._nb = nb
        self._L = L

    def collect(self):
        """(rows_per_cluster, overflow_flags): rows_per_cluster[c] is
        the aligned [(ordinal, row)] list (None where overflow),
        matching align()'s output contract."""
        L = self._L
        C_true = len(self._seqs)
        # ONE download of the full padded packed tensor (fixed shape;
        # device-side slicing with a trial-varying C_true would
        # recompile per super-batch, and each extra sync stalls the host)
        packed = np.asarray(self._packed)[:C_true]
        cpos_np = packed[:, :-3].reshape(C_true, self._nb, -1)
        width_np = packed[:, -3].astype(np.int32) | (
            packed[:, -2].astype(np.int32) << 8
        )
        ovf_np = packed[:, -1].astype(bool)
        out: list = []
        for c, seqs in enumerate(self._seqs):
            if ovf_np[c]:
                out.append(None)
                continue
            w = int(width_np[c])
            rows = []
            for s, q in enumerate(seqs):
                qb = np.frombuffer(q.encode("latin1"), np.uint8)
                qb = np.concatenate(
                    [qb, np.full(L + 1 - len(qb), ord("-"), np.uint8)]
                )
                row = qb[np.minimum(cpos_np[c, s, :w], L)]
                rows.append((s, row.tobytes().decode("latin1")))
            out.append(rows)
        return out, ovf_np


def start_msa_batch(
    P,
    seqs_list: list[list[str]],
    joins_list: list[list[tuple[int, int]]],
    nb: int,
    Lpad: int,
    refine_iters: int,
    seed: int,
) -> MsaJob:
    """Dispatch one bucket batch's full device MSA (progressive +
    refinement + readout) without blocking.

    P: [C_cap, npair, Lpad+1, Lpad+1] device array (f32 or bf16),
    zero-padded at row/col Lpad and on pad pairs/clusters.
    seqs_list/joins_list: the C_true real clusters (C_true <= C_cap)."""
    C_cap = P.shape[0]
    C_true = len(seqs_list)
    # column budget: reads of one strand differ by a few indels, so the
    # aligned width barely exceeds the longest read; +32 covers every
    # observed trial (width overflow falls back to the host aligner)
    Cmax = Lpad + 32
    L = Lpad

    lens = np.zeros((C_cap, nb), np.int32)
    for c, seqs in enumerate(seqs_list):
        for s, q in enumerate(seqs):
            lens[c, s] = len(q)

    nwaves = nb - 1
    jA = np.zeros((nwaves, C_cap, nb), bool)
    jB = np.zeros((nwaves, C_cap, nb), bool)
    for c, (seqs, joins) in enumerate(zip(seqs_list, joins_list)):
        mA, mB = wave_masks(joins, len(seqs), nb)
        jA[:, c, :] = mA
        jB[:, c, :] = mB

    Pblock = build_pblock(P, nb)
    cpos, width = _msa_init(jnp.asarray(lens), Cmax, L)
    cpos, width, ovf = _msa_progressive(
        Pblock, cpos, width, jnp.asarray(jA), jnp.asarray(jB), Cmax, L, nb
    )

    # refinement: per-cluster mask tables by true n (clusters with n < 3
    # skip refinement entirely -> all-false rows)
    tables = {n: refine_mask_table(n, refine_iters, seed) for n in
              {len(s) for s in seqs_list}}
    max_rows = max((t.shape[0] for t in tables.values()), default=0)
    if max_rows and refine_iters:
        # FIXED iteration-axis length per refine_iters setting (one
        # compiled while_loop program per bucket); the loop exits as
        # soon as every cluster is frozen or out of mask rows, so the
        # padding costs nothing
        padded_rows = _round_up(max_rows, max(refine_iters, 1))
        rA_full = np.zeros((padded_rows, C_cap, nb), bool)
        rows_pc = np.zeros(C_cap, np.int32)
        for c, seqs in enumerate(seqs_list):
            tab = tables[len(seqs)]
            if not tab.shape[0]:
                continue
            k, n = tab.shape
            rA_full[:k, c, :n] = tab.astype(bool)
            rows_pc[c] = k
        # numpy-built (jnp .at with a trial-varying C_true bound would
        # compile a fresh eager executable per super-batch shape)
        frozen = jnp.asarray(np.arange(C_cap) >= C_true)
        cpos, width, frozen, ovf = _msa_refine(
            Pblock, cpos, width, frozen, ovf, jnp.asarray(rA_full),
            jnp.asarray(rows_pc), Cmax, L, nb,
        )

    return MsaJob(seqs_list, _msa_readout(cpos, width, ovf), nb, L)


def run_msa_batch(
    P,
    seqs_list: list[list[str]],
    joins_list: list[list[tuple[int, int]]],
    nb: int,
    Lpad: int,
    refine_iters: int,
    seed: int,
):
    """Blocking convenience wrapper: start_msa_batch + collect."""
    return start_msa_batch(
        P, seqs_list, joins_list, nb, Lpad, refine_iters, seed
    ).collect()
