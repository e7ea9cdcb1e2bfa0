"""MSA engine tests: pair-HMM vs scalar oracle, MEA DP vs scalar DP,
UPGMA structure, and end-to-end alignment quality on mutated reads."""

import random

import numpy as np
import pytest

from dna_ldpc_tpu.ops.msa import align, mea_align, mea_score, msa_aligner, upgma_join_order
from dna_ldpc_tpu.ops.msa.pairhmm import pair_fwd_bwd, posterior_from_sweeps

from oracle_pairhmm import oracle_posterior


def _rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mutate(rng, s, subs=0, dels=0, inss=0):
    s = list(s)
    for _ in range(subs):
        s[rng.randrange(len(s))] = rng.choice("ACGT")
    for _ in range(dels):
        del s[rng.randrange(len(s))]
    for _ in range(inss):
        s.insert(rng.randrange(len(s)), rng.choice("ACGT"))
    return "".join(s)


def test_pairhmm_matches_oracle():
    rng = random.Random(0)
    xs, ys = [], []
    for _ in range(6):
        xs.append(_rand_seq(rng, rng.randint(4, 14)))
        ys.append(_rand_seq(rng, rng.randint(4, 14)))
    fwd, w, lx, ly = pair_fwd_bwd(xs, ys)
    for p in range(len(xs)):
        mp, mt = posterior_from_sweeps(fwd, w, int(lx[p]), int(ly[p]), p)
        op, ot = oracle_posterior(xs[p], ys[p])
        assert abs(mt - ot) < 1e-3
        np.testing.assert_allclose(mp, op, atol=2e-4)


def test_pairhmm_related_sequences_high_posterior():
    rng = random.Random(1)
    base = _rand_seq(rng, 60)
    other = _mutate(rng, base, subs=2, dels=1)
    fwd, w, lx, ly = pair_fwd_bwd([base], [other])
    post, _ = posterior_from_sweeps(fwd, w, int(lx[0]), int(ly[0]), 0)
    # most positions should confidently align to their counterpart
    assert (post.max(axis=1) > 0.9).mean() > 0.8


def test_mea_dp_matches_scalar():
    rng = np.random.default_rng(2)
    for _ in range(10):
        LX, LY = rng.integers(1, 15, 2)
        post = (rng.random((LX, LY)) * (rng.random((LX, LY)) < 0.3)).astype(np.float32)
        # scalar reference DP (calcalnflat.cpp recurrence)
        dp = np.zeros((LX + 1, LY + 1), np.float32)
        for i in range(1, LX + 1):
            for j in range(1, LY + 1):
                dp[i, j] = max(dp[i - 1, j - 1] + post[i - 1, j - 1], dp[i - 1, j], dp[i, j - 1])
        assert abs(mea_score(post) - dp[LX, LY]) < 1e-5
        score, path = mea_align(post)
        assert abs(score - dp[LX, LY]) < 1e-5
        # path must be a valid edit script covering both sequences
        nx = sum(c in "BX" for c in path)
        ny = sum(c in "BY" for c in path)
        assert (nx, ny) == (LX, LY)


def test_upgma_join_order_valid():
    rng = np.random.default_rng(3)
    n = 7
    d = rng.random((n, n))
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0)
    joins = upgma_join_order(d)
    assert len(joins) == n - 1
    # simulate pending-set semantics (ValidateJoinOrder)
    pending = set(range(n))
    for k, (a, b) in enumerate(joins):
        assert a in pending and b in pending and a != b
        pending -= {a, b}
        pending.add(n + k)
    assert len(pending) == 1


def test_align_identical_sequences():
    seqs = ["ACGTACGTAA"] * 3
    rows = align(seqs, refine_iters=5)
    assert [r for _, r in rows] == seqs
    assert [o for o, _ in rows] == [0, 1, 2]


def test_align_indel_reads_reconstruct_consensus():
    rng = random.Random(4)
    base = _rand_seq(rng, 136)
    reads = [base] + [
        _mutate(rng, base, subs=rng.randint(0, 3), dels=rng.randint(0, 2), inss=rng.randint(0, 1))
        for _ in range(4)
    ]
    rows = msa_aligner(reads, refine_iters=20)
    mat = np.stack([np.frombuffer(r.encode(), np.uint8) for _, r in rows])
    width = mat.shape[1]
    assert 136 <= width <= 142
    # column-majority consensus restricted to the reference row's letters
    # must equal the original base sequence
    ref_row = mat[[o for o, _ in rows].index(0)]
    keep = ref_row != ord("-")
    consensus = []
    for c in np.nonzero(keep)[0]:
        col = mat[:, c]
        col = col[col != ord("-")]
        vals, counts = np.unique(col, return_counts=True)
        consensus.append(vals[np.argmax(counts)])
    consensus = bytes(consensus).decode()
    mismatches = sum(a != b for a, b in zip(consensus, base))
    assert mismatches <= 3


def test_two_sequence_align_no_consistency_no_refine():
    rng = random.Random(5)
    base = _rand_seq(rng, 50)
    reads = [base, _mutate(rng, base, dels=2)]
    rows = align(reads)
    assert len(rows) == 2
    w = len(rows[0][1])
    assert len(rows[1][1]) == w
    assert rows[1][1].count("-") == 2


def test_sparse_transport_matches_dense():
    """Top-k bf16 sparse device->host transport must reproduce the dense
    posteriors: identical support (0.01-pruned rows hold <= top_k entries)
    and bf16-level value agreement."""
    from dna_ldpc_tpu.ops.msa.pairhmm import batch_posteriors

    rng = random.Random(7)
    xs, ys = [], []
    for _ in range(8):
        base = _rand_seq(rng, rng.randint(40, 120))
        xs.append(base)
        ys.append(_mutate(rng, base, subs=3, dels=2, inss=2))
    dense = batch_posteriors(xs, ys, transport="dense")
    sparse = batch_posteriors(xs, ys, transport="sparse")
    assert len(dense) == len(sparse)
    for d, s in zip(dense, sparse):
        assert d.shape == s.shape
        np.testing.assert_array_equal(d > 0, s > 0)
        np.testing.assert_allclose(s, d, rtol=8e-3, atol=1e-6)


def test_align_clusters_matches_per_cluster_align():
    """The cross-cluster batched path (pair-HMM chunks + device-batched
    consistency transform, ops/msa/consistency.py) must reproduce
    per-cluster align() exactly, including the n >= 3 consistency and
    refinement stages (consflat.cpp semantics)."""
    from dna_ldpc_tpu.ops.msa.align import align, align_clusters

    rng = np.random.default_rng(5)

    def noisy(s, ndel):
        b = list(s)
        for _ in range(ndel):
            del b[rng.integers(0, len(b))]
        return "".join(b)

    clusters = []
    for n in (2, 3, 4, 5, 3):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 136))
        clusters.append([s] + [noisy(s, rng.integers(1, 3)) for _ in range(n - 1)])

    batched = align_clusters(clusters)
    single = [align(cl) for cl in clusters]
    assert batched == single


def test_device_consistency_matches_host_loop():
    """Force the DEVICE consistency path (min_device_clusters=1) on
    clusters that would otherwise fall to the host fallback, and compare
    against the host reference loop. Guards the einsum precision: default
    bf16 operands drift ~2.6e-3, flipping MEA ties; f32 operands at
    Precision.HIGHEST keep it ~1e-5."""
    from dna_ldpc_tpu.ops.msa.align import cluster_pairs
    from dna_ldpc_tpu.ops.msa.consistency import (
        _consistency_host,
        consistency_clusters,
    )
    from dna_ldpc_tpu.ops.msa.pairhmm import batch_posteriors

    rng = random.Random(13)
    clusters = []
    for n in (3, 4, 5):
        base = _rand_seq(rng, 70)
        clusters.append(
            [base] + [_mutate(rng, base, subs=2, dels=1, inss=1) for _ in range(n - 1)]
        )

    cluster_posts = []
    for seqs in clusters:
        pairs = cluster_pairs(len(seqs))
        cluster_posts.append(
            batch_posteriors(
                [seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs],
                transport="dense",
            )
        )

    dev = consistency_clusters(cluster_posts, min_device_clusters=1)
    host = [
        _consistency_host(posts, len(cl), 2)
        for posts, cl in zip(cluster_posts, clusters)
    ]
    for dposts, hposts in zip(dev, host):
        assert len(dposts) == len(hposts)
        for d, h in zip(dposts, hposts):
            assert d.shape == h.shape
            np.testing.assert_allclose(d, h, atol=2e-5, rtol=1e-4)


def test_device_consistency_sparse_in_matches_dense_in():
    """The sparse-in/sparse-out consistency upload (top-k transport
    densified on device) must agree with the dense upload path."""
    from dna_ldpc_tpu.ops.msa.align import cluster_pairs
    from dna_ldpc_tpu.ops.msa.consistency import consistency_clusters
    from dna_ldpc_tpu.ops.msa.pairhmm import (
        batch_posteriors,
        batch_posteriors_sparse,
        densify_sparse,
    )

    rng = random.Random(17)
    clusters = []
    for n in (4, 4, 4, 4):  # one full bucket, >= min_device_clusters
        base = _rand_seq(rng, 64)
        clusters.append(
            [base] + [_mutate(rng, base, subs=1, dels=1, inss=0) for _ in range(n - 1)]
        )

    cluster_posts, cluster_sparse = [], []
    for seqs in clusters:
        pairs = cluster_pairs(len(seqs))
        xs = [seqs[i] for i, _ in pairs]
        ys = [seqs[j] for _, j in pairs]
        vals, idx, lxs, lys, _L = batch_posteriors_sparse(xs, ys)
        cluster_sparse.append((vals, idx))
        cluster_posts.append(
            [densify_sparse(vals[p], idx[p], int(lxs[p]), int(lys[p]))
             for p in range(len(xs))]
        )

    from_dense = consistency_clusters(cluster_posts, min_device_clusters=1)
    from_sparse = consistency_clusters(
        cluster_posts, min_device_clusters=1, cluster_sparse=cluster_sparse
    )
    for a, b in zip(from_dense, from_sparse):
        for d, s in zip(a, b):
            np.testing.assert_allclose(d, s, atol=1e-6)


def test_sparse_transport_overflow_guard():
    """A homopolymer pair produces posterior rows with > 8 surviving
    entries (threshold-only pruning, mysparsemx.h:3-4 keeps them all).
    The sparse transport must widen K rather than silently truncate."""
    from dna_ldpc_tpu.ops.msa.pairhmm import (
        batch_posteriors,
        batch_posteriors_sparse,
    )

    xs, ys = ["A" * 20, "ACGTACGT"], ["A" * 30, "ACGAACGT"]
    dense = batch_posteriors(xs, ys, transport="dense")
    sup = max((d > 0).sum(axis=1).max() for d in dense)
    assert sup > 8  # the construction really does overflow top-8

    vals, idx, lx, ly, Lmax = batch_posteriors_sparse(xs, ys, top_k=8)
    assert vals.shape[-1] >= sup  # K was widened
    sparse = batch_posteriors(xs, ys, transport="sparse", top_k=8)
    for d, s in zip(dense, sparse):
        np.testing.assert_array_equal(d > 0, s > 0)  # no lost entries
        np.testing.assert_allclose(s, d, rtol=8e-3, atol=1e-6)
