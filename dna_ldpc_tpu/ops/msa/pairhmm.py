"""Batched 5-state pair-HMM forward/backward and match posteriors.

Batched replacement for MUSCLE v5's per-pair flat DP
(``MUSCLE/src/fwdflat3.cpp``, ``bwdflat3.cpp``, ``calcposteriorflat.cpp``,
``totalprobflat.cpp``): where MUSCLE walks one (LX+1)x(LY+1)x5 lattice per
OpenMP thread, here a whole batch of pairs is swept together by
ANTIDIAGONALS — every state's dependencies reach only the previous two
diagonals, so each of the ~2L steps is one vectorized slab update over
[n_pairs, L+1] cells, which is how this sequential-looking DP maps onto
a data-parallel device.

Model (pairhmm.h:11-19): states M, IX, IY (short inserts), JX, JY (long
inserts); parameters are MUSCLE's default nucleotide HMM
(defaulthmmparams.cpp:243-279 — START_M=0.6, START_IS=0.02, START_IL=0.18,
M_M=0.96, M_IS=0.012, M_IL=0.008, IS_IS=0.35, IL_IL=0.90; match emissions
0.12 diagonal / 0.044 off-diagonal, insert emissions = row marginals;
wildcard emissions 1/4 and 1/16, hmmparams.cpp:281-...). The model pays
the START score of the final state as an end factor (bwdflat3.cpp's
(LX, LY) special case), and the total probability is the logsumexp over
states at (LX, LY) (totalprobflat.cpp).

Backward pass without a second kernel: Bwd[s][i][j] (suffix probability
given state s at (i,j), its own emission excluded — bwdflat3.cpp's
definition) comes from an auxiliary W-DP over REVERSED sequences. With
a = LX-i, b = LY-j,

    W[s][a][b] := emit_s(rev chars at (a,b)) *
                  sum_s'' trans[s][s''] * W[s''][prev cell of s's move]

is EXACTLY the forward recurrence with the TRANSPOSED transition matrix
(start row unchanged), so one antidiagonal step function serves both
sweeps, and

    Bwd[M][i][j] = logsumexp_s' ( trans[M][s'] + W[s'][a][b] ),
    Bwd[s][LX][LY] = start[s].

Posterior(i~j) = exp(Fwd_M[i,j] + Bwd_M[i,j] - total), zeroed below 0.01
(MIN_SPARSE_PROB, mysparsemx.h:3). The production path
(``batch_posteriors``) stores only the forward M-plane and the
trans-folded backward plane and assembles posteriors ON DEVICE — the full
5-state tensors never leave the device.

:func:`batch_post_ea` is the device-resident entry the MSA flows use:
posteriors stay on device and each pair's MEA/EA score (CalcAlnScoreFlat
over the bf16-rounded posteriors) comes back as one scalar. It runs the
Hopper kernel (``pairhmm_cuda``, native/pairhmm.cu) on the GPU and this
module's XLA formulation elsewhere; the XLA formulation is also the
perturbed-parameter (ensemble) path and the reference the kernel is
compared with.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

LOG_ZERO = -1e30
MIN_SPARSE_PROB = 0.01

# state indices (pairhmm.h HMMSTATE order: M, IX, IY, JX, JY)
M, IX, IY, JX, JY = 0, 1, 2, 3, 4
N_STATE = 5
START = 5  # virtual start state (row 5 of the 6x5 transition tables)


@functools.lru_cache(maxsize=None)
def nucleo_params():
    """(start[5], trans6[6,5], match[5,5], ins[5]) log-space float32;
    symbol 4 is the wildcard (non-ACGT). trans6[START] = start scores."""
    t = {
        ("M", "M"): 0.96, ("M", "IS"): 0.012, ("M", "IL"): 0.008,
        ("IS", "IS"): 0.35, ("IS", "M"): 0.65,
        ("IL", "IL"): 0.90, ("IL", "M"): 0.10,
    }
    diag, other = 0.12, 0.044

    start = np.full(N_STATE, LOG_ZERO, np.float64)
    start[M] = np.log(0.6)
    start[IX] = start[IY] = np.log(0.02)
    start[JX] = start[JY] = np.log(0.18)

    trans = np.full((N_STATE + 1, N_STATE), LOG_ZERO, np.float64)
    trans[M, M] = np.log(t[("M", "M")])
    for s in (IX, IY):
        trans[M, s] = np.log(t[("M", "IS")])
        trans[s, s] = np.log(t[("IS", "IS")])
        trans[s, M] = np.log(t[("IS", "M")])
    for s in (JX, JY):
        trans[M, s] = np.log(t[("M", "IL")])
        trans[s, s] = np.log(t[("IL", "IL")])
        trans[s, M] = np.log(t[("IL", "M")])
    trans[START] = start

    emit = np.full((4, 4), other, np.float64)
    np.fill_diagonal(emit, diag)
    match = np.full((5, 5), np.log(1.0 / 16), np.float64)
    match[:4, :4] = np.log(emit)
    ins = np.full(5, np.log(0.25), np.float64)
    ins[:4] = np.log(emit.sum(axis=1))

    # plain numpy float32 (NOT jnp): this function is lru_cached and may
    # first be called inside a jit trace — caching jnp arrays there would
    # poison the cache with tracers.
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(start), f32(trans), f32(match), f32(ins)


def _reverse_trans_table(trans6: np.ndarray) -> np.ndarray:
    """6x5 transition table for the W-DP: real rows transposed, START row
    unchanged (= start scores)."""
    out = np.full_like(trans6, np.float32(LOG_ZERO))
    out[:N_STATE, :] = trans6[:N_STATE, :].T
    out[START] = trans6[START]
    return out


@functools.lru_cache(maxsize=None)
def _trans_reversed():
    return _reverse_trans_table(nucleo_params()[1])


_ENCODE_TABLE = np.full(256, 4, np.int8)
for _i, _c in enumerate("ACGT"):
    _ENCODE_TABLE[ord(_c)] = _i
    _ENCODE_TABLE[ord(_c.lower())] = _i


def encode_seq(seq: str) -> np.ndarray:
    """ACGT -> 0..3, everything else -> wildcard 4."""
    return _ENCODE_TABLE[np.frombuffer(seq.encode("latin1"), np.uint8)]


def _logsumexp(stack, axis):
    m = jnp.max(stack, axis=axis)
    return m + jnp.log(jnp.sum(jnp.exp(stack - jnp.expand_dims(m, axis)), axis=axis))


def _diag_step(d, prev2, prev1, X, Y, trans6, match, ins, Lmax, rows):
    """Compute one antidiagonal slab [P, 6, W] from the previous two."""
    # parameter tables arrive as host numpy (see nucleo_params); lift to
    # device constants so traced indexing works
    trans6, match, ins = jnp.asarray(trans6), jnp.asarray(match), jnp.asarray(ins)
    P, W = X.shape[0], Lmax + 1
    j = d - rows
    xi = jnp.take(X, jnp.clip(rows - 1, 0, Lmax - 1), axis=1)  # [P, W]
    yj = jnp.take(Y, jnp.clip(j - 1, 0, Lmax - 1), axis=1)
    m_emit = match[xi, yj]
    x_emit = ins[xi]
    y_emit = ins[yj]

    shift = lambda a: jnp.concatenate(
        [jnp.full(a.shape[:-1] + (1,), LOG_ZERO, a.dtype), a[..., :-1]], axis=-1
    )
    p2s = shift(prev2)  # (i-1, j-1)
    p1s = shift(prev1)  # (i-1, j)
    p1 = prev1          # (i, j-1)

    cM = _logsumexp(p2s + trans6[:, M][None, :, None], axis=1) + m_emit

    def ins_state(src, s, emit):
        terms = jnp.stack(
            [src[:, M] + trans6[M, s], src[:, s] + trans6[s, s],
             src[:, START] + trans6[START, s]],
            axis=1,
        )
        return _logsumexp(terms, 1) + emit

    cIX = ins_state(p1s, IX, x_emit)
    cJX = ins_state(p1s, JX, x_emit)
    cIY = ins_state(p1, IY, y_emit)
    cJY = ins_state(p1, JY, y_emit)

    j_ok = (j >= 0) & (j <= Lmax)
    valid = (rows <= jnp.minimum(d, Lmax)) & j_ok
    mask_m = (rows >= 1) & (j >= 1) & valid
    mask_x = (rows >= 1) & valid
    mask_y = (j >= 1) & valid

    neg = jnp.float32(LOG_ZERO)
    return jnp.stack(
        [
            jnp.where(mask_m[None, :], cM, neg),
            jnp.where(mask_x[None, :], cIX, neg),
            jnp.where(mask_y[None, :], cIY, neg),
            jnp.where(mask_x[None, :], cJX, neg),
            jnp.where(mask_y[None, :], cJY, neg),
            jnp.full((P, W), neg),  # START lives only at (0,0)
        ],
        axis=1,
    )


def _dp_init(P, W):
    init0 = jnp.full((P, N_STATE + 1, W), LOG_ZERO, jnp.float32)
    init0 = init0.at[:, START, 0].set(0.0)
    prevm1 = jnp.full((P, N_STATE + 1, W), LOG_ZERO, jnp.float32)
    return prevm1, init0


@functools.partial(jax.jit, static_argnums=(3,))
def _diag_dp(X, Y, trans6, Lmax):
    """Full-tensor DP (testing path). Returns [2*Lmax+1, P, 5, Lmax+1] with
    V[s][i][j] = diags[i+j, :, s, i]."""
    _, _, match, ins = nucleo_params()
    P, W, D = X.shape[0], Lmax + 1, 2 * Lmax
    rows = jnp.arange(W)

    def step(d, carry):
        prev2, prev1, out = carry
        cur = _diag_step(d, prev2, prev1, X, Y, trans6, match, ins, Lmax, rows)
        out = jax.lax.dynamic_update_slice(out, cur[None, :, :N_STATE, :], (d, 0, 0, 0))
        return (prev1, cur, out)

    prevm1, init0 = _dp_init(P, W)
    out = jnp.full((D + 1, P, N_STATE, W), LOG_ZERO, jnp.float32)
    _, _, out = jax.lax.fori_loop(1, D + 1, step, (prevm1, init0, out))
    return out


@functools.partial(jax.jit, static_argnums=(6,))
def _posteriors_device(X, Y, Xr, Yr, lx, ly, Lmax, params=None):
    """Both sweeps + on-device posterior assembly.

    Stores only the forward M-plane, the backward plane pre-folded through
    trans[M][:], and the per-pair forward corner states. Returns
    (post [P, Lmax, Lmax] sparsified, total [P]).

    ``params`` optionally overrides the HMM tables (start, trans6, match,
    ins) — the ensemble replicates' PerturbProbs path (align.cpp:81-120).
    """
    if params is None:
        start, trans6, match, ins = nucleo_params()
        trans_rev = _trans_reversed()
    else:
        start, trans6, match, ins = params
        # jnp-safe reversed table (params may be tracers under jit)
        trans_rev = jnp.full_like(jnp.asarray(trans6), LOG_ZERO)
        trans_rev = trans_rev.at[:N_STATE, :].set(jnp.asarray(trans6)[:N_STATE, :].T)
        trans_rev = trans_rev.at[START].set(jnp.asarray(trans6)[START])
    P, W, D = X.shape[0], Lmax + 1, 2 * Lmax
    rows = jnp.arange(W)
    end_d = lx + ly  # [P]

    def fwd_step(d, carry):
        prev2, prev1, m_plane, corner = carry
        cur = _diag_step(d, prev2, prev1, X, Y, trans6, match, ins, Lmax, rows)
        m_plane = jax.lax.dynamic_update_slice(m_plane, cur[None, :, M, :], (d, 0, 0))
        # capture all-state values at the per-pair corner (lx, ly)
        at_corner = end_d == d
        corner_vals = jnp.take_along_axis(
            cur[:, :N_STATE, :], lx[:, None, None].astype(jnp.int32), axis=2
        )[:, :, 0]
        corner = jnp.where(at_corner[:, None], corner_vals, corner)
        return (prev1, cur, m_plane, corner)

    prevm1, init0 = _dp_init(P, W)
    m_plane0 = jnp.full((D + 1, P, W), LOG_ZERO, jnp.float32)
    corner0 = jnp.full((P, N_STATE), LOG_ZERO, jnp.float32)
    # handle pairs with lx+ly == 0 (both empty): corner = init states
    _, _, m_plane, corner = jax.lax.fori_loop(
        1, D + 1, fwd_step, (prevm1, init0, m_plane0, corner0)
    )

    def bwd_step(d, carry):
        prev2, prev1, b_plane = carry
        cur = _diag_step(d, prev2, prev1, Xr, Yr, trans_rev, match, ins, Lmax, rows)
        folded = _logsumexp(cur[:, :N_STATE, :] + trans6[M][None, :, None], axis=1)
        b_plane = jax.lax.dynamic_update_slice(b_plane, folded[None], (d, 0, 0))
        return (prev1, cur, b_plane)

    prevm1, init0 = _dp_init(P, W)
    b_plane0 = jnp.full((D + 1, P, W), LOG_ZERO, jnp.float32)
    _, _, b_plane = jax.lax.fori_loop(1, D + 1, bwd_step, (prevm1, init0, b_plane0))

    total = _logsumexp(corner + start[None, :], axis=1)  # [P]

    # FM[p, i, j] = m_plane[i+j, p, i] for i, j in 1..Lmax
    ii = jnp.arange(1, Lmax + 1)
    FM = m_plane[ii[:, None] + ii[None, :], :, ii[:, None]]  # [Lmax, Lmax, P]
    FM = jnp.moveaxis(FM, -1, 0)  # [P, Lmax, Lmax]

    # BM[p, i, j] = b_plane[a+b, p, a], a = lx-i, b = ly-j; corner -> start[M]
    a = lx[:, None] - ii[None, :]          # [P, Lmax]
    b = ly[:, None] - ii[None, :]          # [P, Lmax]
    a_c = jnp.clip(a, 0, Lmax)
    d_idx = jnp.clip(a_c[:, :, None] + jnp.clip(b, 0, Lmax)[:, None, :], 0, D)
    flat = b_plane.transpose(1, 0, 2).reshape(P, (D + 1) * W)
    BM = jnp.take_along_axis(
        flat, (d_idx * W + a_c[:, :, None]).reshape(P, -1), axis=1
    ).reshape(P, Lmax, Lmax)
    at_corner = (a[:, :, None] == 0) & (b[:, None, :] == 0)
    BM = jnp.where(at_corner, start[M], BM)

    post = jnp.exp(jnp.minimum(FM + BM - total[:, None, None], 0.0))
    valid = (ii[None, :, None] <= lx[:, None, None]) & (ii[None, None, :] <= ly[:, None, None])
    post = jnp.where(valid & (post >= MIN_SPARSE_PROB), post, 0.0)
    return post, total


def padded_lmax(seqs_x, seqs_y) -> int:
    """The DP width for a batch: the longest sequence rounded up to a
    multiple of 32 (at least 32), so batches share compiled shapes."""
    raw = max((len(s) for s in list(seqs_x) + list(seqs_y)), default=1)
    return max(32, -(-max(raw, 1) // 32) * 32)


def encode_pairs(seqs_x, seqs_y, Lmax: int | None = None, rows: int | None = None):
    """Pack a batch of pairs for the DP: (X, Y [rows, Lmax] int32 codes,
    wildcard 4 past each sequence and in pad rows; lx, ly [rows] int32
    lengths, 0 in pad rows; Lmax). ``rows`` defaults to the pair count.

    int32, not int8: gathers from sub-word integer arrays compile far
    more slowly in XLA, and the code tensors are tiny."""
    from ...utils.dna import seqs_to_matrix

    P = len(seqs_x)
    rows = P if rows is None else rows
    if Lmax is None:
        Lmax = padded_lmax(seqs_x, seqs_y)
    X = np.full((rows, Lmax), 4, np.int32)
    Y = np.full((rows, Lmax), 4, np.int32)
    lx = np.zeros(rows, np.int32)
    ly = np.zeros(rows, np.int32)
    if P:
        lx[:P] = [len(s) for s in seqs_x]
        ly[:P] = [len(s) for s in seqs_y]
        if max(lx.max(), ly.max()) > Lmax:
            raise ValueError(f"a sequence is longer than Lmax={Lmax}")
        X[:P] = _ENCODE_TABLE[seqs_to_matrix(seqs_x, pad=Lmax)]
        Y[:P] = _ENCODE_TABLE[seqs_to_matrix(seqs_y, pad=Lmax)]
    return X, Y, lx, ly, Lmax


def _reverse_codes(X, lengths):
    """Each row's first ``lengths`` codes reversed, wildcard 4 after
    (numpy or jnp)."""
    xp = np if isinstance(X, np.ndarray) else jnp
    L = X.shape[1]
    src = lengths[:, None] - 1 - xp.arange(L)[None, :]
    rev = xp.take_along_axis(X, xp.maximum(src, 0), axis=1)
    return xp.where(src >= 0, rev, 4).astype(X.dtype)


def _encode_batch(seqs_x, seqs_y, Lmax):
    """encode_pairs with the pair axis padded to a power of two (so
    varying batch sizes share compiled shapes) plus the reversed codes
    the backward sweep reads: (X, Y, Xr, Yr, lx_pad, ly_pad, lx, ly,
    Lmax)."""
    P = len(seqs_x)
    Pb = 1 << (P - 1).bit_length() if P > 1 else 1
    X, Y, lxp, lyp, Lmax = encode_pairs(seqs_x, seqs_y, Lmax, rows=Pb)
    Xr, Yr = _reverse_codes(X, lxp), _reverse_codes(Y, lyp)
    return X, Y, Xr, Yr, lxp, lyp, lxp[:P].copy(), lyp[:P].copy(), Lmax


def round_to_bf16(x):
    """Round f32 values to the nearest bf16 value, staying f32. An
    explicit reduce_precision: XLA may drop a f32->bf16->f32 convert
    pair as excess precision (it does on the GPU), this it keeps."""
    return jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=7)


def _mea_scores(post, lx, ly):
    """MEA alignment score per pair (CalcAlnScoreFlat) over the
    bf16-rounded posteriors: S[i,j] = max(S[i-1,j-1] + p(i,j), S[i-1,j],
    S[i,j-1]) with S[i,0] = S[0,j] = 0, returned at (lx, ly).

    One row per scan step: with A[j] = max(S[i-1,j-1] + p(i,j), S[i-1,j])
    and A[0] = 0, S[i,:] = cummax(A) — the same f32 additions on the same
    paths as the host mea_score, so the score is bit-exact. The bf16
    rounding reproduces the values the sparse transport carries."""
    P, L, _ = post.shape
    pq = round_to_bf16(post)
    zero_col = jnp.zeros((P, 1), jnp.float32)

    def row(carry, xs):
        S_prev, best = carry
        i, p_row = xs
        A = jnp.maximum(S_prev[:, :-1] + p_row, S_prev[:, 1:])
        S = jax.lax.cummax(jnp.concatenate([zero_col, A], axis=1), axis=1)
        at = jnp.take_along_axis(S, ly[:, None], axis=1)[:, 0]
        return (S, jnp.where(lx == i, at, best)), None

    init = (jnp.zeros((P, L + 1), jnp.float32), jnp.zeros((P,), jnp.float32))
    (_, best), _ = jax.lax.scan(
        row, init, (jnp.arange(1, L + 1), jnp.moveaxis(pq, 1, 0))
    )
    return best


@functools.partial(jax.jit, static_argnums=(4,))
def _post_ea_xla(X, Y, lx, ly, Lmax):
    """XLA entry: (post [P, Lmax, Lmax] sparsified posteriors, ea [P]
    MEA scores) from packed codes (encode_pairs)."""
    post, _ = _posteriors_device(
        X, Y, _reverse_codes(X, lx), _reverse_codes(Y, ly), lx, ly, Lmax
    )
    return post, _mea_scores(post, lx, ly)


def _platform() -> str:
    return jax.default_backend()


def batch_post_ea(seqs_x, seqs_y, Lmax: int | None = None):
    """Device-resident posteriors + EA scores for a batch of pairs:
    (post [P, Lmax, Lmax] f32 device array, ea [P] f32 device array, lx,
    ly, Lmax). The Hopper kernel on the GPU; the XLA formulation on the
    CPU, with the pair axis padded to a power of two so batch sizes share
    compiled programs."""
    P = len(seqs_x)
    platform = _platform()
    if platform == "gpu":
        from .pairhmm_cuda import post_ea_cuda

        X, Y, lx, ly, Lmax = encode_pairs(seqs_x, seqs_y, Lmax)
        post, ea = post_ea_cuda(X, Y, lx, ly)
    elif platform == "cpu":
        Pb = 1 << (P - 1).bit_length() if P > 1 else 1
        X, Y, lx, ly, Lmax = encode_pairs(seqs_x, seqs_y, Lmax, rows=Pb)
        post, ea = _post_ea_xla(X, Y, lx, ly, Lmax)
        if Pb != P:
            post, ea = post[:P], ea[:P]
    else:
        raise ValueError(f"no pair-HMM path for platform {platform!r}")
    return post, ea, lx[:P], ly[:P], Lmax


@functools.partial(jax.jit, static_argnums=(1,))
def _sparsify_post(post, top_k):
    """post [P, Lmax, Lmax] -> top-k transport (bf16 vals, 1-based uint8
    idx, 0 = pruned) + the maximum per-row surviving support (for the
    losslessness guard: rows with support > top_k would be silently
    truncated)."""
    vals, idx = jax.lax.top_k(post, top_k)
    keep = vals > 0.0
    valsq = jnp.where(keep, vals, 0.0).astype(jnp.bfloat16)
    idx1 = jnp.where(keep, idx + 1, 0).astype(jnp.uint8)
    max_sup = jnp.max(jnp.sum(post > 0.0, axis=-1))
    return valsq, idx1, max_sup


class SparseJob:
    """Async handle for one sparse-posterior chunk: the device work is
    dispatched at construction; :meth:`collect` materializes the host
    arrays (and applies the top-k losslessness guard). Keeping several
    jobs in flight overlaps host-side sequence encoding with device
    compute and transfers."""

    def __init__(self, vals, idx, max_sup, redo, P, lx, ly, Lmax, top_k):
        self._vals, self._idx, self._max_sup = vals, idx, max_sup
        self._redo, self._P, self._top_k = redo, P, top_k
        self.lx, self.ly, self.Lmax = lx, ly, Lmax

    def collect(self):
        vals, idx = self._vals, self._idx
        k_needed = int(self._max_sup)
        if k_needed > self._top_k:  # lossless guard: widen K, redo top-k
            vals, idx, _ = self._redo(k_needed)
        return (
            np.asarray(vals, np.float32)[: self._P],
            np.asarray(idx)[: self._P],
            self.lx, self.ly, self.Lmax,
        )


def batch_posteriors_sparse_start(
    seqs_x: list[str], seqs_y: list[str], Lmax: int | None = None, params=None,
    top_k: int = 8,
) -> SparseJob:
    """Dispatch one chunk's pair-HMM + top-k sparsification without
    blocking on the result; see :class:`SparseJob`."""
    P = len(seqs_x)
    if params is None:
        post, _ea, lx, ly, Lmax = batch_post_ea(seqs_x, seqs_y, Lmax)
        if Lmax > 255:
            raise ValueError("sparse transport requires Lmax <= 255 (uint8 indices)")
        vals, idx, max_sup = _sparsify_post(post, top_k)
        return SparseJob(
            vals, idx, max_sup, lambda k: _sparsify_post(post, k),
            P, lx, ly, Lmax, top_k,
        )

    X, Y, Xr, Yr, lxp, lyp, lx, ly, Lmax = _encode_batch(seqs_x, seqs_y, Lmax)
    if Lmax > 255:
        raise ValueError("sparse transport requires Lmax <= 255 (uint8 indices)")
    args = (
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xr), jnp.asarray(Yr),
        jnp.asarray(lxp), jnp.asarray(lyp), Lmax,
    )
    vals, idx, max_sup = _posteriors_device_sparse(*args, top_k, params)
    return SparseJob(
        vals, idx, max_sup,
        lambda k: _posteriors_device_sparse(*args, k, params),
        P, lx, ly, Lmax, top_k,
    )


def batch_posteriors_sparse(
    seqs_x: list[str], seqs_y: list[str], Lmax: int | None = None, params=None,
    top_k: int = 8,
):
    """Match posteriors in the raw top-k sparse transport form.

    Returns (vals [P, Lmax, K] bf16-as-f32 numpy, idx [P, Lmax, K] uint8
    1-based with 0 = pruned, lx [P], ly [P], Lmax). The sparse triplet is
    the cheapest device<->host currency (16-20x smaller than dense) and
    round-trips losslessly: ``top_k`` is a MINIMUM — if any posterior row
    has more than top_k surviving entries (possible for repetitive
    reads; MySparseMx prunes by threshold only, mysparsemx.h:3-4), the
    chunk is re-sparsified at the actual maximum support, so K may come
    back larger. Re-uploading the triplet for the device-batched
    consistency transform feeds bit-identical values."""
    return batch_posteriors_sparse_start(
        seqs_x, seqs_y, Lmax, params, top_k
    ).collect()


def densify_sparse(vals: np.ndarray, idx: np.ndarray, lx: int, ly: int) -> np.ndarray:
    """One pair's sparse rows -> dense [lx, ly] f32 (host side)."""
    L = vals.shape[0]
    dense = np.zeros((L, L + 1), np.float32)
    dense[np.arange(L)[:, None], idx.astype(np.int64)] = vals
    return dense[:lx, 1 : ly + 1]


def batch_posteriors(
    seqs_x: list[str], seqs_y: list[str], Lmax: int | None = None, params=None,
    transport: str = "auto", top_k: int = 8,
) -> list[np.ndarray]:
    """Production path: match posteriors for a batch of pairs, assembled on
    device. ``params`` optionally overrides the HMM tables (ensemble
    perturbation).

    ``transport`` controls the device->host form:

    - ``"dense"``: one [P, Lmax, Lmax] f32 tensor (exact; ~52 MB per 512
      pairs at Lmax=160);
    - ``"sparse"``: per row, the ``top_k`` entries as bf16 values + uint8
      column indices assembled ON DEVICE — ~26x less transfer. The 0.01
      sparsity threshold (MIN_SPARSE_PROB) already prunes posterior rows
      to a handful of entries for DNA-storage-like reads, so top-8 is
      lossless in practice; rows are renormalization-free (values are
      used additively downstream). Requires Lmax <= 255 (1-based uint8
      column indices; 0 is the prune marker).
    - ``"auto"``: sparse when eligible, else dense.
    """
    P = len(seqs_x)
    if transport == "auto":
        # the padded width, or a raw length of e.g. 250 would probe
        # "sparse" while the padded Lmax of 256 exceeds the uint8 range
        probe_L = Lmax if Lmax is not None else padded_lmax(seqs_x, seqs_y)
        transport = "sparse" if probe_L <= 255 else "dense"
    if transport == "sparse":
        vals, idx, lx, ly, Lmax = batch_posteriors_sparse(
            seqs_x, seqs_y, Lmax, params, top_k
        )
        out = []
        rows = np.arange(vals.shape[1])[:, None]
        for p in range(P):
            # indices are 1-based with 0 = pruned: scatter into an extra
            # leading column that acts as the prune sink, then drop it
            dense = np.zeros((Lmax, Lmax + 1), np.float32)
            dense[rows, idx[p].astype(np.int64)] = vals[p]
            out.append(dense[: lx[p], 1 : ly[p] + 1])
        return out
    if params is None:
        post, _ea, lx, ly, Lmax = batch_post_ea(seqs_x, seqs_y, Lmax)
        post = np.asarray(post)
        return [post[p, : lx[p], : ly[p]] for p in range(P)]
    X, Y, Xr, Yr, lxp, lyp, lx, ly, Lmax = _encode_batch(seqs_x, seqs_y, Lmax)
    post, _ = _posteriors_device(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xr), jnp.asarray(Yr),
        jnp.asarray(lxp), jnp.asarray(lyp), Lmax, params,
    )
    post = np.asarray(post)
    return [post[p, : lx[p], : ly[p]] for p in range(P)]


@functools.partial(jax.jit, static_argnums=(6, 7))
def _posteriors_device_sparse(X, Y, Xr, Yr, lx, ly, Lmax, top_k, params=None):
    """Top-k row sparsification of the match posteriors, on device.

    Posterior columns are 1-based (j in 1..Lmax maps to post[:, :, j-1]);
    the returned uint8 indices are the 1-based j of each kept entry, with
    0 marking pruned slots (values there are exactly 0) — the host
    scatters into column j and drops column 0. Also returns the maximum
    per-row surviving support (losslessness guard)."""
    post, _ = _posteriors_device(X, Y, Xr, Yr, lx, ly, Lmax, params)
    vals, idx = jax.lax.top_k(post, top_k)             # [P, Lmax, K]
    keep = vals > 0.0
    vals = jnp.where(keep, vals, 0.0).astype(jnp.bfloat16)
    idx1 = jnp.where(keep, idx + 1, 0).astype(jnp.uint8)
    max_sup = jnp.max(jnp.sum(post > 0.0, axis=-1))
    return vals, idx1, max_sup


# ---------------------------------------------------------------------------
# Full-tensor reference path (kept for tests / debugging)
# ---------------------------------------------------------------------------


def _rev_pad(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    out = np.full_like(codes, 4)
    for p in range(codes.shape[0]):
        L = int(lengths[p])
        out[p, :L] = codes[p, :L][::-1]
    return out


def _np_logsumexp(v, axis=None):
    m = np.max(v, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(v - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None else float(out.reshape(()))


def pair_fwd_bwd(seqs_x: list[str], seqs_y: list[str], Lmax: int | None = None):
    """Both sweeps with full tensors on host (testing path)."""
    X, Y, Xr, Yr, lxp, lyp, lx, ly, Lmax = _encode_batch(seqs_x, seqs_y, Lmax)
    _, trans6, _, _ = nucleo_params()
    fwd = np.asarray(_diag_dp(jnp.asarray(X), jnp.asarray(Y), trans6, Lmax))
    w = np.asarray(_diag_dp(jnp.asarray(Xr), jnp.asarray(Yr), _trans_reversed(), Lmax))
    return fwd, w, lx, ly


def posterior_from_sweeps(fwd, w, lx: int, ly: int, p: int) -> tuple[np.ndarray, float]:
    """Posterior + total for pair p of a pair_fwd_bwd batch (host math)."""
    startv, trans, _, _ = nucleo_params()

    iidx = np.arange(1, lx + 1)
    jidx = np.arange(1, ly + 1)
    FM = fwd[iidx[:, None] + jidx[None, :], p, M, iidx[:, None]]

    a = lx - iidx
    b = ly - jidx
    Wall = w[a[:, None] + b[None, :], p, :, a[:, None]]  # [lx, ly, 5]
    BM = _np_logsumexp(Wall + trans[M][None, None, :], axis=2)
    BM[-1, -1] = startv[M]  # (a, b) == (0, 0)

    Fend = fwd[lx + ly, p, :, lx]
    total = _np_logsumexp(Fend + startv)

    post = np.exp(np.minimum(FM + BM - total, 0.0))
    post[post < MIN_SPARSE_PROB] = 0.0
    return post.astype(np.float32), total


def pair_posteriors(seqs_x: list[str], seqs_y: list[str]) -> list[np.ndarray]:
    """Match posterior matrices for a batch of sequence pairs."""
    return batch_posteriors(seqs_x, seqs_y)
