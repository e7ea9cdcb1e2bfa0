"""Device-resident batched MSA (ops/msa/device_msa) vs the host path.

The device MSA reimplements MUSCLE's ProgressiveAlign/RefineIter merge
machinery (progalnflat.cpp:41-100, refineflat.cpp:4-31; see the module
docstring) as batched XLA programs.  Every operation mirrors the host
path (ops/msa/align.py + native/ingest.cpp) except BuildPost's float
summation order and its bf16 matmul input rounding, so per-cluster outputs
are expected to match the host aligner exactly in all but rare
near-tie cases; these tests pin the match rate at 100% on a seeded
workload and check structural validity plus the fallback paths.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dna_ldpc_tpu.ops.msa.align import (  # noqa: E402
    align,
    cluster_pairs,
    mea_score,
    upgma_join_order,
    _align_clusters_device,
)
from dna_ldpc_tpu.ops.msa.consistency import _consistency_host  # noqa: E402
from dna_ldpc_tpu.ops.msa.pairhmm import batch_posteriors  # noqa: E402
from dna_ldpc_tpu.ops.msa import device_msa  # noqa: E402

BASES = "ACGT"


def _mutate(s, rng, sub=0.02, dele=0.015, ins=0.015):
    out = []
    for ch in s:
        r = rng.random()
        if r < sub:
            out.append(BASES[rng.integers(4)])
        elif r < sub + dele:
            continue
        elif r < sub + dele + ins:
            out.extend([ch, BASES[rng.integers(4)]])
        else:
            out.append(ch)
    return "".join(out)


def _random_clusters(seed, count, nmax=9, base_len=60):
    rng = np.random.default_rng(seed)
    clusters = []
    for _ in range(count):
        n = int(rng.integers(2, nmax))
        base = "".join(BASES[i] for i in rng.integers(0, 4, base_len))
        clusters.append([_mutate(base, rng) for _ in range(n)])
    return clusters


def _host_reference(seqs):
    """Host align() with the same consistency-transformed posteriors the
    device batch receives, plus the inputs run_msa_batch needs."""
    n = len(seqs)
    pairs = cluster_pairs(n)
    posts = batch_posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs])
    dist = np.zeros((n, n))
    for p, (i, j) in enumerate(pairs):
        ea = mea_score(posts[p]) / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = 1.0 - min(max(ea, 0.0), 1.0)
    plist = _consistency_host(list(posts), n, 2) if n >= 3 else list(posts)
    joins = upgma_join_order(dist)
    host = align(seqs, pair_posts=plist, pair_dists=dist, consistency_iters=0)
    return plist, joins, host


def test_run_msa_batch_matches_host_align():
    clusters = _random_clusters(seed=3, count=16)
    Lpad = 96
    nb = 8
    npair = nb * (nb - 1) // 2
    P = np.zeros((len(clusters), npair, Lpad + 1, Lpad + 1), np.float32)
    ii, jj = np.triu_indices(nb, k=1)
    slot = {(int(a), int(b)): s for s, (a, b) in enumerate(zip(ii, jj))}
    joins_list, host_out = [], []
    for c, seqs in enumerate(clusters):
        plist, joins, host = _host_reference(seqs)
        for p, (i, j) in enumerate(cluster_pairs(len(seqs))):
            m = plist[p]
            P[c, slot[(i, j)], : m.shape[0], : m.shape[1]] = m
        joins_list.append(joins)
        host_out.append(host)

    rows_out, ovf = device_msa.run_msa_batch(
        jnp.asarray(P), clusters, joins_list, nb, Lpad, 100, 0
    )
    assert not ovf.any()
    matches = 0
    for c, seqs in enumerate(clusters):
        dev = dict(rows_out[c])
        # structural validity: de-gapped rows reproduce the inputs, all
        # rows share one width
        widths = {len(r) for r in dev.values()}
        assert len(widths) == 1
        for s, row in dev.items():
            assert row.replace("-", "") == seqs[s]
        if dev == dict(host_out[c]):
            matches += 1
    # BuildPost sum-order/bf16 divergence may flip rare near-ties; on
    # this seeded workload every cluster matches the host path exactly
    assert matches == len(clusters)


def test_pad_sizes_are_inert():
    """A cluster aligned alone must match the same cluster padded into
    a larger batch (pad clusters and pad sequence slots are inert)."""
    clusters = _random_clusters(seed=11, count=3, nmax=5)
    Lpad = 96
    nb = 4
    npair = nb * (nb - 1) // 2
    ii, jj = np.triu_indices(nb, k=1)
    slot = {(int(a), int(b)): s for s, (a, b) in enumerate(zip(ii, jj))}

    def run(cl_list, C_cap):
        P = np.zeros((C_cap, npair, Lpad + 1, Lpad + 1), np.float32)
        joins_list = []
        for c, seqs in enumerate(cl_list):
            plist, joins, _ = _host_reference(seqs)
            for p, (i, j) in enumerate(cluster_pairs(len(seqs))):
                m = plist[p]
                P[c, slot[(i, j)], : m.shape[0], : m.shape[1]] = m
            joins_list.append(joins)
        rows, ovf = device_msa.run_msa_batch(
            jnp.asarray(P), cl_list, joins_list, nb, Lpad, 100, 0
        )
        return rows

    solo = [run([cl], 8)[0] for cl in clusters]
    batched = run(clusters, 8)
    for a, b in zip(solo, batched):
        assert dict(a) == dict(b)


def test_align_clusters_device_end_to_end():
    """The integrated GPU flow (platform pair-HMM entry + device
    consistency + device MSA, here on the CPU) matches the host
    align_clusters output."""
    clusters = _random_clusters(seed=5, count=8, nmax=7, base_len=48)
    dev = _align_clusters_device(clusters, 100, 2, 0, 64, None, {})

    from dna_ldpc_tpu.ops.msa.align import align_clusters

    host = align_clusters(clusters)
    assert sum(1 for a, b in zip(dev, host) if dict(a) == dict(b)) == len(clusters)


def test_overflow_falls_back_to_host():
    """Unrelated sequences whose alignment exceeds the device column
    budget (Lmax + 64) must be detected and re-aligned on host."""
    rng = np.random.default_rng(9)
    # two unrelated 120-nt sequences: MEA alignment is nearly a
    # concatenation (~width 200+), far past Cmax = 128 + 64
    unrelated = ["".join(BASES[i] for i in rng.integers(0, 4, 120)) for _ in range(2)]
    rel_base = "".join(BASES[i] for i in rng.integers(0, 4, 120))
    related = [_mutate(rel_base, rng) for _ in range(3)]
    clusters = [unrelated, related]
    out = _align_clusters_device(clusters, 100, 2, 0, 64, None, {})
    for c, seqs in enumerate(clusters):
        rows = dict(out[c])
        assert len({len(r) for r in rows.values()}) == 1
        for s, row in rows.items():
            assert row.replace("-", "") == seqs[s]


def test_refine_mask_table_matches_host_rng():
    """Device mask tables replicate align()'s numpy Generator draw with
    all-same rows removed."""
    n, iters, seed = 5, 100, 0
    tab = device_msa.refine_mask_table(n, iters, seed)
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 2, (iters, n)).astype(np.uint8)
    keep = ~((masks.all(axis=1)) | (~masks.any(axis=1)))
    assert np.array_equal(tab, masks[keep])
    assert device_msa.refine_mask_table(2, iters, seed).shape == (0, 2)
