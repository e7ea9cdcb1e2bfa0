"""Native ingest library tests: C++ counting and edit distance must be
bit-identical to the Python reference paths."""

import random

import numpy as np
import pytest

from dna_ldpc_tpu import native_lib
from dna_ldpc_tpu.ops.editdist import edit_distance_pairs
from dna_ldpc_tpu.pipeline.llr import FilteredReads, compute_trial_llrs
from dna_ldpc_tpu.utils.dna import seqs_to_matrix

pytestmark = pytest.mark.skipif(not native_lib.available(), reason="no g++ toolchain")


def _rand_read(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _identity_aligner(seqs):
    return [(i, (s + "-" * 136)[:136]) for i, s in enumerate(seqs)]


def test_native_counting_matches_python():
    rng = random.Random(1)
    payloads, quals, strands = [], [], []
    strand = 0
    for _ in range(200):
        k = rng.randint(1, 5)
        case = rng.random()
        for i in range(k):
            if case < 0.5:
                L = 136
            elif case < 0.75:
                L = 136 if i else rng.randint(40, 135)
            else:
                L = rng.choice([128, 136, 141])
            payloads.append(_rand_read(rng, L))
            quals.append(rng.choice([40, 52, 53, 63, 64, 70]))
            strands.append(strand)
        strand += rng.randint(1, 2)
    f = FilteredReads(
        payloads=payloads,
        quals=np.array(quals),
        strands=np.array(strands),
        n_input=len(payloads),
        n_rs_pass=len(payloads),
    )
    t_nat = compute_trial_llrs(f, 0.02, _identity_aligner, use_native=True)
    t_py = compute_trial_llrs(f, 0.02, _identity_aligner, use_native=False)
    assert np.array_equal(t_nat, t_py)


def test_native_edit_distance_matches_numpy():
    rng = random.Random(2)
    seqs = [_rand_read(rng, rng.randint(0, 40)) for _ in range(40)]
    mat = seqs_to_matrix(seqs, fill=b"\x00")
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    a, b = np.triu_indices(40, k=1)
    want = edit_distance_pairs(mat, lens.astype(np.int64), a, b)

    buf = np.frombuffer("".join(seqs).encode(), np.uint8).copy()
    offs = np.zeros(len(seqs), np.int64)
    offs[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    got = native_lib.edit_distance_batch_native(buf, offs, lens, a, b)
    assert np.array_equal(got, want)


def test_device_edit_distance_matches_numpy():
    """The one-dispatch device DP (ops/editdist.edit_distance_pairs_device)
    is an integer recurrence — results must be bit-identical to the
    numpy sweep, including empty strings and maximal-length pairs."""
    from dna_ldpc_tpu.ops.editdist import edit_distance_pairs_device

    rng = random.Random(5)
    seqs = [_rand_read(rng, rng.randint(0, 40)) for _ in range(40)]
    seqs[0] = ""  # empty-vs-nonempty boundary cells
    mat = seqs_to_matrix(seqs, fill=b"\x00")
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    a, b = np.triu_indices(40, k=1)
    want = edit_distance_pairs(mat, lens, a, b)
    got = edit_distance_pairs_device(mat, lens, a, b)
    assert np.array_equal(got, want)


def test_native_align_matches_python_path():
    """align(use_native=True) and align(use_native=False) must produce
    identical rows: the C++ progressive-alignment+refine port
    (native/ingest.cpp msa_progressive_refine) claims bit-compatibility
    with ops/msa/align.py, and once the library builds every MSA test
    silently runs only the native path — this is the explicit parity
    check."""
    from dna_ldpc_tpu.ops.msa.align import align

    rng = random.Random(11)

    def mutate(s, subs, dels, inss):
        b = list(s)
        for _ in range(subs):
            b[rng.randrange(len(b))] = rng.choice("ACGT")
        for _ in range(dels):
            del b[rng.randrange(len(b))]
        for _ in range(inss):
            b.insert(rng.randrange(len(b)), rng.choice("ACGT"))
        return "".join(b)

    for n, L in ((3, 60), (4, 90), (5, 136)):
        base = "".join(rng.choice("ACGT") for _ in range(L))
        seqs = [base] + [
            mutate(base, rng.randint(0, 2), rng.randint(0, 2), rng.randint(0, 2))
            for _ in range(n - 1)
        ]
        nat = align(seqs, use_native=True)
        py = align(seqs, use_native=False)
        assert nat == py


def test_native_sparse_posts_match_dense(monkeypatch):
    """msa_progressive_refine_sp (sparse top-k transport, no host
    densification) must be bit-identical to the dense-posterior entry:
    within a pair every sparse entry hits a distinct BuildPost cell, so
    only the unchanged profile-row loop order affects f32 sums."""
    from dna_ldpc_tpu.ops.msa.align import align, cluster_pairs, upgma_join_order
    from dna_ldpc_tpu.ops.msa.pairhmm import batch_posteriors_sparse, densify_sparse

    rng = random.Random(23)

    def mutate(s, k):
        b = list(s)
        for _ in range(k):
            op = rng.randrange(3)
            if op == 0:
                b[rng.randrange(len(b))] = rng.choice("ACGT")
            elif op == 1 and len(b) > 2:
                del b[rng.randrange(len(b))]
            else:
                b.insert(rng.randrange(len(b)), rng.choice("ACGT"))
        return "".join(b)

    for n, L in ((3, 50), (5, 90)):
        base = "".join(rng.choice("ACGT") for _ in range(L))
        seqs = [base] + [mutate(base, rng.randint(1, 3)) for _ in range(n - 1)]
        pairs = cluster_pairs(n)
        sv, si, lxs, lys, _L = batch_posteriors_sparse(
            [seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs]
        )
        posts = [
            densify_sparse(sv[p], si[p], int(lxs[p]), int(lys[p]))
            for p in range(len(pairs))
        ]
        # EA distances from the same posteriors (align() formula)
        from dna_ldpc_tpu.ops.msa.align import mea_score

        dist = np.zeros((n, n))
        for p, (i, j) in enumerate(pairs):
            ea = mea_score(posts[p]) / min(len(seqs[i]), len(seqs[j]))
            dist[i, j] = dist[j, i] = 1.0 - min(max(ea, 0.0), 1.0)

        dense_rows = align(
            seqs, consistency_iters=0, pair_posts=posts, pair_dists=dist
        )
        sparse_rows = align(
            seqs, consistency_iters=0,
            pair_posts_sparse=(sv, si, lxs.astype(np.int32)), pair_dists=dist,
        )
        assert dense_rows == sparse_rows
