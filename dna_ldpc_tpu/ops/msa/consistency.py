"""Device-batched consistency transform for the MPC pipeline.

The reference applies two consistency iterations per cluster with an
OpenMP loop over pairs of sparse matrix triple-products
(``MUSCLE/src/consflat.cpp:5-23``, ``conspairflat.cpp``,
``relaxflat.cpp:4-91``):

    P'_XY = (2 P_XY + sum_{Z != X,Y} P_XZ @ P_ZY) / n

restricted to P_XY's existing support (MySparseMx::UpdateFromPost).

Here the transform is a batched einsum: clusters are stacked into a
block tensor A[c, i, j, a, b] (A[c,i,i] = 0, A[c,j,i] = A[c,i,j]^T), for
which

    sum_z A[i,z] @ A[z,j]  ==  the reference's sum over Z != X,Y

because the diagonal blocks are zero — so both iterations are plain
[n*L, n*L] block matmuls, batched over every
cluster of a trial at once instead of a Python dict-loop per pair
(the round-2 bottleneck at align.py:379-396).

Compile economy: compiles cost far more than padded FLOPs, so cluster
sizes are BUCKETED to n in N_BUCKETS
(currently {3, 4, 6, 8, 12, 16, 24, 32}; zero member blocks are inert in
the block matmul, and the divide-by-n uses the true per-cluster n) and
the cluster axis is padded to a fixed chunk — one compiled program per
bucket regardless of the trial's cluster mix. Sizes above the top
bucket and tiny groups fall back to an identical host loop.
The fused flow (_consistency_fused, driven by the fused align_clusters)
gathers inputs from device-resident chunk posteriors instead of
re-uploading the sparse transport.

Results return to host via the same lossless top-k sparse transport as
the pair-HMM posteriors (support after masking is bounded by the
original <= top_k-entry rows, ops/msa/pairhmm.py batch_posteriors).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .pairhmm import MIN_SPARSE_PROB, round_to_bf16

N_BUCKETS = (3, 4, 6, 8, 12, 16, 24, 32)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _consistency_device(pair_mats, inv_n, n, iters):
    return _consistency_core(pair_mats, inv_n, n, iters)


def _consistency_core(pair_mats, inv_n, n, iters, operand_dtype=jnp.float32):
    """pair_mats: [C, n*(n-1)/2, L, L] stacked i<j pair posteriors (zero
    padded; n is the BUCKET size). inv_n: [C] per-cluster 1/n_true.
    Returns the transformed pairs in the same layout.

    Matmul precision, stated per operand dtype (the same on every
    platform):

    - float32 (default): f32 operands at ``Precision.HIGHEST`` — no TF32
      or bf16 passes; the batched path stays within ~1e-5 of align()'s
      host loop (bf16 inputs drift ~2.6e-3 and flip MEA traceback ties).
    - bfloat16 (the device-resident MSA flow): operands rounded to bf16
      (relative error <= 2^-9), f32 accumulation. Its BuildPost consumes
      bf16 operands anyway, so f32 products would buy precision the
      downstream immediately rounds off."""
    C, npair, L, _ = pair_mats.shape
    ii, jj = np.triu_indices(n, k=1)
    precision = (
        jax.lax.Precision.HIGHEST if operand_dtype == jnp.float32
        else jax.lax.Precision.DEFAULT  # bf16 x bf16 products are exact in f32
    )

    # scatter pairs into the block tensor A[c, i, j, a, b]
    A = jnp.zeros((C, n, n, L, L), pair_mats.dtype)
    A = A.at[:, ii, jj].set(pair_mats)
    A = A.at[:, jj, ii].set(jnp.swapaxes(pair_mats, -1, -2))
    scale = inv_n[:, None, None, None, None]

    for _ in range(iters):
        # sum_z A[i,z] @ A[z,j]; the z == i and z == j terms vanish
        # because the diagonal blocks are zero
        Aop = A.astype(operand_dtype)
        S = jnp.einsum(
            "cizab,czjbd->cijad", Aop, Aop, preferred_element_type=jnp.float32,
            precision=precision,
        )
        A = jnp.where(A < MIN_SPARSE_PROB, 0.0, (2.0 * A + S) * scale)

    return A[:, ii, jj]


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _consistency_sparse_in_out(vals, idx, inv_n, n, iters, top_k):
    """Sparse-in / sparse-out consistency: inputs arrive in the pair-HMM
    top-k transport form (vals [C, npair, L, K] f32, idx uint8 1-based,
    0 = pruned) and are densified ON DEVICE — the host<->device traffic
    is 16-20x smaller than shipping dense pair matrices."""
    C, npair, L, K = vals.shape
    dense = jnp.zeros((C, npair, L, L + 1), jnp.float32)
    c = jnp.arange(C)[:, None, None, None]
    p = jnp.arange(npair)[None, :, None, None]
    r = jnp.arange(L)[None, None, :, None]
    # vals may arrive as bf16: the pair-HMM sparse transport is bf16, so
    # the host's f32 copies are bf16-representable and the half-size
    # upload is lossless
    dense = dense.at[c, p, r, idx.astype(jnp.int32)].set(vals.astype(jnp.float32))
    out = _consistency_device(dense[..., 1:], inv_n, n, iters)
    ovals, oidx = jax.lax.top_k(out, top_k)
    keep = ovals > 0.0
    ovals = jnp.where(keep, ovals, 0.0)
    oidx1 = jnp.where(keep, oidx + 1, 0).astype(jnp.uint8)
    return ovals, oidx1


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _consistency_device_sparse(pair_mats, inv_n, n, iters, top_k):
    """Consistency + on-device top-k row sparsification (f32 values —
    full precision, unlike the raw-posterior transport's bf16; with the
    einsum pinned to Precision.HIGHEST the batched path stays within
    ~1e-5 of align()'s host loop — 1-based uint8 column indices, 0 =
    pruned)."""
    out = _consistency_device(pair_mats, inv_n, n, iters)
    vals, idx = jax.lax.top_k(out, top_k)
    keep = vals > 0.0
    vals = jnp.where(keep, vals, 0.0)
    idx1 = jnp.where(keep, idx + 1, 0).astype(jnp.uint8)
    return vals, idx1


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _consistency_fused(chunkA, chunkB, ids, mask, inv_n, n, iters, top_k):
    """Consistency transform gathered straight from DEVICE-RESIDENT
    pair-HMM chunk posteriors — no sparse download/re-upload (the fused
    align_clusters path).

    chunkA/chunkB: two consecutive [P_chunk, L, L] chunk post tensors
    (the window that covers this dispatch's contiguous global pair
    range; pass the same tensor twice at the tail). ids [C*npair] int32
    window-local pair ids per (cluster, slot); mask flags real slots.
    The gathered posteriors are rounded through bf16 to exactly match
    the values the host path densifies from the sparse transport, so
    batched and per-cluster align() stay equivalent. Returns the same
    top-k transport (+ max input row support for the losslessness
    guard) as _consistency_device_sparse."""
    C = inv_n.shape[0]
    npair = n * (n - 1) // 2
    L = chunkA.shape[-1]
    sel = jnp.take(jnp.concatenate([chunkA, chunkB], 0), ids, axis=0)
    sel = jnp.where(mask[:, None, None], sel, 0.0)
    pair_mats = round_to_bf16(sel).reshape(C, npair, L, L)
    max_sup = jnp.max(jnp.sum(pair_mats > 0.0, axis=-1))
    out = _consistency_core(pair_mats, inv_n, n, iters)
    vals, idx = jax.lax.top_k(out, top_k)
    keep = vals > 0.0
    vals = jnp.where(keep, vals, 0.0)
    idx1 = jnp.where(keep, idx + 1, 0).astype(jnp.uint8)
    return vals, idx1, max_sup


def _consistency_host(posts: list[np.ndarray], n: int, iters: int) -> list[np.ndarray]:
    """Host-numpy consistency for one cluster (align()'s reference loop);
    used for cluster sizes where a device compile isn't worth it."""
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    d = {(i, j): p for (i, j), p in zip(pairs, posts)}
    for _ in range(iters):
        new = {}
        for (i, j), Pij in d.items():
            acc = 2.0 * Pij
            for z in range(n):
                if z == i or z == j:
                    continue
                Piz = d[(i, z)] if i < z else d[(z, i)].T
                Pzj = d[(z, j)] if z < j else d[(j, z)].T
                acc = acc + Piz @ Pzj
            upd = acc / n
            upd[Pij < MIN_SPARSE_PROB] = 0.0
            new[(i, j)] = upd
        d = new
    return [d[p] for p in pairs]


def consistency_clusters(
    cluster_posts: list[list[np.ndarray]],
    iters: int = 2,
    chunk_elems: int = 1 << 26,
    top_k: int = 8,
    min_device_clusters: int = 4,
    cluster_sparse=None,
) -> list[list[np.ndarray]]:
    """Apply ``iters`` consistency iterations to every cluster's pair
    posteriors on device.

    ``cluster_posts[c]`` holds cluster c's C(n_c, 2) posteriors in
    cluster_pairs order, with per-pair shapes [len_i, len_j]. Clusters
    with fewer than 3 sequences pass through unchanged (mpcflat.cpp:185).
    ``chunk_elems`` bounds each device tensor's element count.

    ``cluster_sparse`` optionally supplies, per cluster, the raw top-k
    transport triplet (vals [npair_c, L, K], idx [npair_c, L, K]) from
    pairhmm.batch_posteriors_sparse; the device upload then uses the
    sparse form (16-20x smaller) and densifies on device, producing
    bit-identical results.
    """
    out: list[list[np.ndarray] | None] = [None] * len(cluster_posts)

    groups: dict[int, list[tuple[int, int]]] = {}  # bucket -> [(c, n_true)]
    host_jobs: list[tuple[int, int]] = []
    for c, posts in enumerate(cluster_posts):
        npair = len(posts)
        if npair < 3:  # n < 3: consistency skipped
            out[c] = posts
            continue
        n = int(round((1 + np.sqrt(1 + 8 * npair)) / 2))
        nb = next((b for b in N_BUCKETS if b >= n), None)
        if nb is None:
            host_jobs.append((c, n))
        else:
            groups.setdefault(nb, []).append((c, n))

    # one shared L bucket for every group (stable compile keys): the
    # trial's reads are all ~136 nt, so this is 160 in practice
    L_all = 1
    for posts in cluster_posts:
        for p in posts:
            L_all = max(L_all, p.shape[0], p.shape[1])
    L = max(32, -(-L_all // 32) * 32)

    for nb, members in sorted(groups.items()):
        if len(members) < min_device_clusters:
            host_jobs.extend(members)
            continue
        npair_b = nb * (nb - 1) // 2
        ii_b, jj_b = np.triu_indices(nb, k=1)
        slot_of = {(int(a), int(b)): s for s, (a, b) in enumerate(zip(ii_b, jj_b))}
        # output support is bounded by the input support per row
        # (UpdateFromPost masking), so top-(max input row support) keeps
        # the sparse transport lossless
        max_sup = max(
            (int((mat > 0).sum(axis=1).max(initial=0)) for c, _ in members
             for mat in cluster_posts[c]),
            default=0,
        )
        k = min(L, max(top_k, max_sup))
        use_sparse = L <= 255
        chunk = max(1, chunk_elems // (npair_b * L * L))
        for lo in range(0, len(members), chunk):
            batch = members[lo : lo + chunk]
            # pad the cluster axis to the full chunk: exactly ONE compiled
            # einsum per bucket — compiles are far more expensive than
            # the wasted FLOPs on pad clusters
            inv_n = np.ones(chunk, np.float32)
            if cluster_sparse is not None and use_sparse:
                # clusters re-sparsified by the losslessness guard may
                # carry K > top_k: size the upload to the batch max
                K = max(cluster_sparse[c][0].shape[-1] for c, _ in batch)
                import ml_dtypes

                sv = np.zeros((chunk, npair_b, L, K), ml_dtypes.bfloat16)
                si = np.zeros((chunk, npair_b, L, K), np.uint8)
                for bi, (c, n) in enumerate(batch):
                    inv_n[bi] = 1.0 / n
                    cv, ci = cluster_sparse[c]
                    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                    for pi, (i, j) in enumerate(pairs):
                        s = slot_of[(i, j)]
                        sv[bi, s, : cv.shape[1], : cv.shape[2]] = cv[pi]
                        si[bi, s, : ci.shape[1], : ci.shape[2]] = ci[pi]
                vals, idx = _consistency_sparse_in_out(
                    jnp.asarray(sv), jnp.asarray(si), jnp.asarray(inv_n),
                    nb, iters, k,
                )
                vals = np.asarray(vals, np.float32)
                idx = np.asarray(idx).astype(np.int64)
                rows = np.arange(L)[:, None]
                for bi, (c, n) in enumerate(batch):
                    res = []
                    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                    for (i, j), mat in zip(pairs, cluster_posts[c]):
                        s = slot_of[(i, j)]
                        dense = np.zeros((L, L + 1), np.float32)
                        dense[rows, idx[bi, s]] = vals[bi, s]
                        res.append(dense[: mat.shape[0], 1 : mat.shape[1] + 1])
                    out[c] = res
                continue
            stacked = np.zeros((chunk, npair_b, L, L), np.float32)
            for bi, (c, n) in enumerate(batch):
                inv_n[bi] = 1.0 / n
                pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                for (i, j), mat in zip(pairs, cluster_posts[c]):
                    stacked[bi, slot_of[(i, j)], : mat.shape[0], : mat.shape[1]] = mat
            if use_sparse:
                vals, idx = _consistency_device_sparse(
                    jnp.asarray(stacked), jnp.asarray(inv_n), nb, iters, k
                )
                vals = np.asarray(vals, np.float32)  # [chunk, npair_b, L, K]
                idx = np.asarray(idx).astype(np.int64)
                rows = np.arange(L)[:, None]
                for bi, (c, n) in enumerate(batch):
                    res = []
                    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                    for (i, j), mat in zip(pairs, cluster_posts[c]):
                        s = slot_of[(i, j)]
                        dense = np.zeros((L, L + 1), np.float32)
                        dense[rows, idx[bi, s]] = vals[bi, s]
                        res.append(dense[: mat.shape[0], 1 : mat.shape[1] + 1])
                    out[c] = res
            else:
                trans = np.asarray(
                    _consistency_device(jnp.asarray(stacked), jnp.asarray(inv_n), nb, iters)
                )
                for bi, (c, n) in enumerate(batch):
                    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                    out[c] = [
                        trans[bi, slot_of[(i, j)], : mat.shape[0], : mat.shape[1]]
                        for (i, j), mat in zip(pairs, cluster_posts[c])
                    ]

    for c, n in host_jobs:
        out[c] = _consistency_host(cluster_posts[c], n, iters)
    return out
