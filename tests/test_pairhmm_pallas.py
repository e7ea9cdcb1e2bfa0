"""Device-resident pair-HMM entry (ops/msa/pairhmm.batch_post_ea) and
the MSA flows built on it.

On the GPU the entry runs the Hopper kernel (native/pairhmm.cu), on the
CPU the XLA antidiagonal formulation — itself validated against the
scalar oracle (oracle_pairhmm.py) and the reference the kernel is
compared with (the ``gpu``-marked test below, run on the card).
"""

import random

import ml_dtypes
import numpy as np
import pytest

from dna_ldpc_tpu.ops.msa import pairhmm
from dna_ldpc_tpu.ops.msa.align import mea_score
from dna_ldpc_tpu.ops.msa.pairhmm import batch_post_ea, batch_posteriors, densify_sparse


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


def _pairs(seed, length, n=6):
    rng = random.Random(seed)
    xs, ys = [], []
    for _ in range(n):
        base = _rand_seq(rng, length)
        xs.append(base)
        ys.append(_mutate(rng, base, subs=2, dels=1, inss=1))
    xs += [_rand_seq(rng, length // 2), "", "A" * 20]
    ys += [_rand_seq(rng, length), "ACGT", "A" * 25]
    return xs, ys


@pytest.mark.parametrize("length", [24, 150])
def test_xla_ea_entry_matches_host_mea_score(length):
    """The XLA entry's EA scores (scan + cummax over bf16-rounded
    posteriors) equal host mea_score on the same values bit for bit,
    and its posteriors equal the dense transport's."""
    xs, ys = _pairs(length, length)
    post, ea, lx, ly, Lmax = batch_post_ea(xs, ys)
    assert Lmax == max(32, -(-max(length, 25) // 32) * 32)
    post, ea = np.asarray(post), np.asarray(ea)
    assert post.shape == (len(xs), Lmax, Lmax) and ea.shape == (len(xs),)
    dense = batch_posteriors(xs, ys, transport="dense")
    for p in range(len(xs)):
        q = post[p, : lx[p], : ly[p]]
        np.testing.assert_array_equal(q, dense[p])
        bf = q.astype(ml_dtypes.bfloat16).astype(np.float32)
        host = mea_score(bf) if bf.size else 0.0
        assert np.float32(host) == np.float32(ea[p])


def test_cuda_wrapper_padding_and_shapes(monkeypatch):
    """The GPU branch of batch_post_ea with the FFI call stubbed: codes
    packed to [P, Lmax] int32 with wildcard padding, exact lengths, the
    95 kernel parameters, and outputs passed through at [P, Lmax, Lmax]
    and [P]."""
    from dna_ldpc_tpu.ops.msa import pairhmm_cuda

    seen = {}

    def fake_ffi(X, Y, lx, ly, params):
        import jax.numpy as jnp

        seen.update(X=np.asarray(X), Y=np.asarray(Y), lx=np.asarray(lx),
                    ly=np.asarray(ly), params=np.asarray(params))
        P, L = X.shape
        return jnp.zeros((P, L, L), jnp.float32), jnp.arange(P, dtype=jnp.float32)

    monkeypatch.setattr(pairhmm, "_platform", lambda: "gpu")
    monkeypatch.setattr(pairhmm_cuda, "_ffi_post_ea", fake_ffi)
    xs = ["ACGT" * 10, "", "TTGCA"]
    ys = ["ACG", "GGGG", "N" * 33]
    post, ea, lx, ly, Lmax = batch_post_ea(xs, ys)
    assert Lmax == 64  # longest read 40 -> next multiple of 32
    assert post.shape == (3, 64, 64) and ea.shape == (3,)
    assert seen["X"].shape == (3, 64) and seen["X"].dtype == np.int32
    np.testing.assert_array_equal(seen["lx"], [40, 0, 5])
    np.testing.assert_array_equal(seen["ly"], [3, 4, 33])
    np.testing.assert_array_equal(seen["X"][0, :4], [0, 1, 2, 3])
    assert (seen["X"][0, 40:] == 4).all() and (seen["X"][1] == 4).all()
    assert (seen["Y"][2, :33] == 4).all()  # non-ACGT -> wildcard
    assert seen["params"].shape == (95,) and seen["params"].dtype == np.float32
    start, trans6, match, ins = pairhmm.nucleo_params()
    np.testing.assert_array_equal(seen["params"][:5], start)
    np.testing.assert_array_equal(seen["params"][90:], ins)
    np.testing.assert_array_equal(lx, [40, 0, 5])
    with pytest.raises(ValueError):
        batch_post_ea(["A" * 70], ["A"], Lmax=64)


def test_pairhmm_platform_choice(monkeypatch):
    monkeypatch.setattr(pairhmm, "_platform", lambda: "rocm")
    with pytest.raises(ValueError):
        batch_post_ea(["ACGT"], ["ACG"])


@pytest.mark.gpu
def test_cuda_kernel_matches_xla_reference(gpu):
    """On the card: kernel posteriors within 1e-5 of the XLA entry at
    Lmax=160, EA scores equal bit for bit (also a chip_smoke phase)."""
    from dna_ldpc_tpu.ops.msa.pairhmm_cuda import post_ea_cuda

    xs, ys = _pairs(7, 150, n=60)
    X, Y, lx, ly, Lmax = pairhmm.encode_pairs(xs, ys, 160)
    post_k, ea_k = post_ea_cuda(X, Y, lx, ly)
    post_x, ea_x = pairhmm._post_ea_xla(X, Y, lx, ly, Lmax)
    np.testing.assert_allclose(np.asarray(post_k), np.asarray(post_x), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ea_k), np.asarray(ea_x))


def test_fused_align_clusters_matches_per_cluster_align(monkeypatch):
    """The device-fused align_clusters flow (posteriors resident on
    device, on-device EA scores and consistency gather) must reproduce
    per-cluster align() exactly — including n=2 raw pass-through, every
    bucket size, and the n>16 host-consistency fallback."""
    import numpy as np

    from dna_ldpc_tpu.ops.msa.align import align, _align_clusters_fused

    rng = np.random.default_rng(9)

    def noisy(s, nd):
        b = list(s)
        for _ in range(nd):
            del b[rng.integers(0, len(b))]
        return "".join(b)

    clusters = []
    for n in (1, 2, 3, 5, 9, 17, 4):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 24))
        cl = [s] + [noisy(s, int(rng.integers(1, 3))) for _ in range(n - 1)]
        clusters.append(cl)

    fused = _align_clusters_fused(
        clusters, refine_iters=10, consistency_iters=2, seed=0,
        pair_chunk=160, n_workers=2,
    )
    single = [align(cl, refine_iters=10) for cl in clusters]
    assert fused == single


def test_fused_align_clusters_no_consistency(monkeypatch):
    """consistency_iters=0 routes every cluster through the raw zone of
    the fused flow; results must still match per-cluster align()."""
    import numpy as np

    from dna_ldpc_tpu.ops.msa.align import align, _align_clusters_fused

    rng = np.random.default_rng(21)

    def noisy(s, nd):
        b = list(s)
        for _ in range(nd):
            del b[rng.integers(0, len(b))]
        return "".join(b)

    clusters = []
    for n in (2, 4, 3):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 30))
        clusters.append([s] + [noisy(s, int(rng.integers(1, 3))) for _ in range(n - 1)])

    fused = _align_clusters_fused(
        clusters, refine_iters=5, consistency_iters=0, seed=0,
        pair_chunk=128, n_workers=2,
    )
    single = [align(cl, refine_iters=5, consistency_iters=0) for cl in clusters]
    assert fused == single


def test_fused_align_clusters_overflow_cluster(monkeypatch):
    """A homopolymer cluster whose posterior rows overflow top-8 must
    round-trip losslessly through the fused raw zone (the per-chunk
    guard widens K) and still match per-cluster align()."""
    from dna_ldpc_tpu.ops.msa.align import align, _align_clusters_fused

    clusters = [["A" * 20, "A" * 30]]  # support 13 > 8 (raw zone, n=2)
    fused = _align_clusters_fused(
        clusters, refine_iters=5, consistency_iters=2, seed=0,
        pair_chunk=128, n_workers=1,
    )
    single = [align(cl, refine_iters=5) for cl in clusters]
    assert fused == single


def test_fused_align_clusters_odd_pair_chunk(monkeypatch):
    """A pair_chunk that is neither a power of two nor a multiple of 8:
    the chunk tensors the pair-HMM entry returns must hold exactly
    pair_chunk rows, or the window arithmetic breaks."""
    import numpy as np

    from dna_ldpc_tpu.ops.msa.align import align, _align_clusters_fused

    rng = np.random.default_rng(31)

    def noisy(s, nd):
        b = list(s)
        for _ in range(nd):
            del b[rng.integers(0, len(b))]
        return "".join(b)

    clusters = []
    for n in (3, 4, 2, 5):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 24))
        clusters.append([s] + [noisy(s, int(rng.integers(1, 3))) for _ in range(n - 1)])

    fused = _align_clusters_fused(
        clusters, refine_iters=5, consistency_iters=2, seed=0,
        pair_chunk=130, n_workers=2,   # not a multiple of 8
    )
    single = [align(cl, refine_iters=5) for cl in clusters]
    assert fused == single


def test_fused_align_clusters_host_consistency_fallback(monkeypatch):
    """Clusters above the largest device bucket take the dense host
    consistency branch; force it with a tiny bucket list so the branch
    is exercised without a 33-sequence cluster."""
    import numpy as np

    import dna_ldpc_tpu.ops.msa.consistency as cm
    from dna_ldpc_tpu.ops.msa.align import align, _align_clusters_fused

    monkeypatch.setattr(cm, "N_BUCKETS", (3, 4))
    rng = np.random.default_rng(41)

    def noisy(s, nd):
        b = list(s)
        for _ in range(nd):
            del b[rng.integers(0, len(b))]
        return "".join(b)

    clusters = []
    for n in (6, 3, 2):  # 6 > max bucket 4 -> host consistency
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 24))
        clusters.append([s] + [noisy(s, int(rng.integers(1, 3))) for _ in range(n - 1)])

    fused = _align_clusters_fused(
        clusters, refine_iters=5, consistency_iters=2, seed=0,
        pair_chunk=128, n_workers=2,
    )
    single = [align(cl, refine_iters=5) for cl in clusters]
    assert fused == single


def test_pallas_randomized_stress(monkeypatch):
    """Randomized shapes (multiple Lmax buckets, empty/single-char/
    homopolymer pathologies): the device entry's posteriors match the
    dense transport and its EA scores equal host mea_score on the
    sparse-transport values bit for bit."""
    from dna_ldpc_tpu.ops.msa.pairhmm import batch_posteriors_sparse

    rng = random.Random(99)

    def rs(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    def mut(s, k):
        s = list(s)
        for _ in range(k):
            op = rng.randrange(3)
            if op == 0 and s:
                s[rng.randrange(len(s))] = rng.choice("ACGT")
            elif op == 1 and len(s) > 1:
                del s[rng.randrange(len(s))]
            else:
                s.insert(rng.randrange(len(s)), rng.choice("ACGT"))
        return "".join(s)

    for trial in range(3):
        Lpick = rng.choice([24, 48, 90])
        xs, ys = [], []
        for _ in range(rng.randint(3, 8)):
            b = rs(rng.randint(1, Lpick))
            xs.append(b)
            ys.append(mut(b, rng.randint(0, 4)))
        xs += ["", "A", "A" * min(Lpick, 25)]
        ys += [rs(3), "", "A" * min(Lpick, 30)]

        dense = batch_posteriors(xs, ys, transport="dense")
        post, ea, lx, ly, _L = batch_post_ea(xs, ys)
        post = np.asarray(post)
        ea = np.asarray(ea)
        sv, si, lxs, lys, _ = batch_posteriors_sparse(xs, ys)
        for p in range(len(xs)):
            d = dense[p]
            q = post[p, : lx[p], : ly[p]]
            assert d.shape == q.shape
            if d.size:
                np.testing.assert_allclose(q, d, atol=2e-4, rtol=2e-4)
            dd = densify_sparse(sv[p], si[p], int(lxs[p]), int(lys[p]))
            host_ea = mea_score(dd) if dd.size else 0.0
            assert np.float32(host_ea) == np.float32(ea[p])
