"""MUSCLE-v5-equivalent multiple sequence alignment (MPC pipeline).

From-scratch re-design of the reference's vendored MUSCLE v5 ``-align``
path (``MUSCLE/src/mpcflat.cpp:288-313`` Run sequence):

1. all C(n,2) pair posteriors via the batched pair HMM (ops/msa/pairhmm,
   replacing the OpenMP loop at mpcflat.cpp:246-254);
2. consistency transform x2 (skipped for <3 sequences, mpcflat.cpp:185):
   P'_XY = (2 P_XY + sum_{Z != X,Y} P_XZ @ P_ZY) / n, support restricted
   to the original sparsity pattern (conspairflat.cpp:29-31 factor 2,
   MySparseMx::UpdateFromPost divide-by-SeqCount). The sparse
   triple-products of relaxflat.cpp become small dense matmuls here —
   L x L with L <= ~160, a batched-matmul-shaped operation;
3. guide tree: UPGMA5 with biased linkage on 1 - EA distances
   (EA = MEA-score/min(LX,LY), calcposteriorflat.cpp:85; FixEADistMx,
   upgma5.cpp:423-438; LINKAGE_Biased = 0.1*avg + 0.9*min,
   upgma5.cpp:228-230);
4. progressive alignment along the join order: profile-profile posterior
   (BuildPost, buildpostflat.cpp:18-100), MEA DP with B>=X>=Y tie
   preference (CalcAlnFlat/Best3), gap insertion by path
   (AlignAlns, alnalnsflat.cpp);
5. iterative refinement x100: random bipartition re-alignment
   (RefineIter, refineflat.cpp:4-31; rand()%2 -> seeded RNG here),
   skipped for <3 sequences (mpcflat.cpp:257-267).

Output rows are returned in input order together with their input
ordinals, matching what the pipeline's aligner interface expects.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .pairhmm import MIN_SPARSE_PROB, batch_posteriors

CONSISTENCY_ITERS = 2   # pairhmm.h:8
REFINE_ITERS = 100      # pairhmm.h:9
GAP = ord("-")


# ---------------------------------------------------------------------------
# MEA alignment DP (CalcAlnFlat + TraceBackFlat)
# ---------------------------------------------------------------------------


def _mea_sweep(post: np.ndarray, want_tb: bool):
    """Antidiagonal max-DP sweep. The cell recurrence of calcalnflat.cpp
    (B = diag + post, X = up, Y = left; tie preference B >= X >= Y from
    Best3's argument order) depends only on the previous two antidiagonals,
    so each of the LX+LY steps is one vectorized slab update instead of a
    scalar inner loop."""
    LX, LY = post.shape
    W = LX + 1
    NEG = np.float32(-np.inf)
    prev2 = np.full(W, NEG, np.float32)
    prev1 = np.full(W, NEG, np.float32)
    prev2[0] = 0.0       # (0,0)
    if LX >= 1:
        prev1[1] = 0.0   # (1,0)
    prev1[0] = 0.0       # (0,1) if LY >= 1
    tb = np.full((LX + 1, LY + 1), b"Y", dtype="S1") if want_tb else None
    if want_tb:
        tb[1:, 0] = b"X"
    i_all = np.arange(W)
    for d in range(2, LX + LY + 1):
        i_lo, i_hi = max(0, d - LY), min(d, LX)
        i = i_all[i_lo : i_hi + 1]
        j = d - i
        ok_b = (i >= 1) & (j >= 1)
        pB = np.where(
            ok_b,
            prev2[np.maximum(i - 1, 0)]
            + post[np.maximum(i - 1, 0), np.maximum(j - 1, 0)] * ok_b,
            NEG,
        )
        pX = np.where(i >= 1, prev1[np.maximum(i - 1, 0)], NEG)
        pY = np.where(j >= 1, prev1[i], NEG)
        # boundary cells (i==0 or j==0) have value 0
        best = np.maximum(np.maximum(pB, pX), pY)
        boundary = (i == 0) | (j == 0)
        best = np.where(boundary, 0.0, best)
        cur = np.full(W, NEG, np.float32)
        cur[i_lo : i_hi + 1] = best
        if want_tb:
            choice = np.where(
                pB >= np.maximum(pX, pY), b"B", np.where(pX >= pY, b"X", b"Y")
            )
            choice = np.where(boundary & (i > 0), b"X", choice)
            choice = np.where(boundary & (i == 0), b"Y", choice)
            tb[i, j] = choice
        prev2, prev1 = prev1, cur
    score = float(prev1[LX]) if LX + LY >= 1 else 0.0
    return score, tb


def mea_align(post: np.ndarray) -> tuple[float, str]:
    """MEA DP + traceback; path chars 'B' (both), 'X', 'Y'. Uses the native
    C++ DP when available (identical recurrence/tie-breaks)."""
    from ... import native_lib

    if native_lib.available():
        return native_lib.mea_align_native(post)
    LX, LY = post.shape
    score, tb = _mea_sweep(post, want_tb=True)
    path = []
    i, j = LX, LY
    while i or j:
        c = tb[i, j]
        path.append(c)
        if c == b"B":
            i, j = i - 1, j - 1
        elif c == b"X":
            i -= 1
        else:
            j -= 1
    return score, b"".join(reversed(path)).decode()


def mea_score(post: np.ndarray) -> float:
    """Score-only sweep (CalcAlnScoreFlat) for EA distances."""
    from ... import native_lib

    if native_lib.available():
        return native_lib.mea_score_native(post)
    return _mea_sweep(post, want_tb=False)[0]


# ---------------------------------------------------------------------------
# UPGMA5 (biased linkage) + join order
# ---------------------------------------------------------------------------


def upgma_join_order(dist: np.ndarray) -> list[tuple[int, int]]:
    """UPGMA clustering with LINKAGE_Biased; returns the join list in
    creation order, node ids: leaves 0..n-1, internal n+k for join k —
    the exact structure ProgressiveAlign consumes (progalnflat.cpp)."""
    n = dist.shape[0]
    D = dist.astype(np.float64).copy()
    np.fill_diagonal(D, np.inf)
    active = list(range(n))
    node_of = {i: i for i in range(n)}
    joins = []
    next_node = n
    for _ in range(n - 1):
        # find global nearest pair among active rows
        sub = D[np.ix_(active, active)]
        k = int(np.argmin(sub))
        ai, aj = divmod(k, len(active))
        i, j = active[ai], active[aj]
        joins.append((node_of[i], node_of[j]))
        # merge j into i with biased linkage
        for m in active:
            if m in (i, j):
                continue
            dm = 0.1 * (D[i, m] + D[j, m]) / 2 + 0.9 * min(D[i, m], D[j, m])
            D[i, m] = D[m, i] = dm
        active.remove(j)
        node_of[i] = next_node
        next_node += 1
    return joins


def joins_to_newick(joins: list[tuple[int, int]], labels: list[str] | None = None) -> str:
    """Serialize a UPGMA join list as a Newick tree string (the guide
    tree object the reference builds in ``MUSCLE/src/tree.cpp`` and can
    emit via its ``-guidetreeout`` style tooling). Branch lengths are
    omitted (join order is all the progressive aligner consumes)."""
    n = len(joins) + 1
    name = {i: (labels[i] if labels else f"s{i}") for i in range(n)}
    for k, (a, b) in enumerate(joins):
        name[n + k] = f"({name.pop(a)},{name.pop(b)})"
    (root,) = name.values()
    return root + ";"


def permute_join_order(
    joins: list[tuple[int, int]], perm: str
) -> list[tuple[int, int]]:
    """MUSCLE guide-tree permutations (``permutetree.cpp`` PermuteTree):
    split the tree into A (the subtree whose leaf count is closest to 1/3
    of the leaves), then split the remainder in half into B and C, and
    rejoin as ``abc``=((A,B),C), ``acb``=((A,C),B), ``bca``=((B,C),A).
    Trees with fewer than 10 leaves are returned unchanged
    (permutetree.cpp:69-75). Node ids follow upgma_join_order's
    convention: leaves 0..n-1, internal n+k for join k."""
    n = len(joins) + 1
    if perm in (None, "none") or n < 10:
        return list(joins)
    if perm not in ("abc", "acb", "bca"):
        raise ValueError(f"unknown tree permutation {perm!r}")

    # nested-tuple tree structure (children precede parents in the join list)
    node: dict[int, object] = {i: i for i in range(n)}
    for k, (a, b) in enumerate(joins):
        node[n + k] = (node[a], node[b])
    root = node[n + len(joins) - 1]

    def leaf_count(s) -> int:
        return 1 if isinstance(s, int) else leaf_count(s[0]) + leaf_count(s[1])

    def leaf_set(s) -> set:
        return {s} if isinstance(s, int) else leaf_set(s[0]) | leaf_set(s[1])

    def divide_fraction(tree, fract):
        """Split off the subtree whose leaf count best matches
        fract * total (DivideTreeFraction; first best in pre-order wins,
        the root itself excluded so the remainder is nonempty)."""
        total = leaf_count(tree)
        target = max(1, int(total * fract + 0.5))
        best, best_diff = None, None
        stack = [(tree, True)]
        while stack:
            s, is_root = stack.pop()
            if not is_root:
                diff = abs(leaf_count(s) - target)
                if best_diff is None or diff < best_diff:
                    best, best_diff = s, diff
            if not isinstance(s, int):
                stack.append((s[1], False))
                stack.append((s[0], False))
        keep = leaf_set(tree) - leaf_set(best)

        def induce(s):
            if isinstance(s, int):
                return s if s in keep else None
            left, right = induce(s[0]), induce(s[1])
            if left is None:
                return right
            if right is None:
                return left
            return (left, right)

        return best, induce(tree)

    A, BC = divide_fraction(root, 0.33)
    B, C = divide_fraction(BC, 0.5)
    permuted = {"abc": ((A, B), C), "acb": ((A, C), B), "bca": ((B, C), A)}[perm]

    out: list[tuple[int, int]] = []

    def flatten(s) -> int:  # post-order join emission
        if isinstance(s, int):
            return s
        a, b = flatten(s[0]), flatten(s[1])
        out.append((a, b))
        return n + len(out) - 1

    flatten(permuted)
    return out


def guide_tree_newick(seqs: list[str], labels: list[str] | None = None) -> str:
    """Compute the MPC guide tree for ``seqs`` (pair-HMM EA distances +
    UPGMA biased linkage, mpcflat.cpp:195-208) and return it as Newick."""
    from .pairhmm import batch_posteriors

    n = len(seqs)
    if n == 1:
        return ((labels[0] if labels else "s0")) + ";"
    pairs = cluster_pairs(n)
    posts = batch_posteriors([seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs])
    dist = np.zeros((n, n))
    for p, (i, j) in enumerate(pairs):
        ea = mea_score(posts[p]) / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = 1.0 - min(max(ea, 0.0), 1.0)
    return joins_to_newick(upgma_join_order(dist), labels)


# ---------------------------------------------------------------------------
# Profiles and gap insertion
# ---------------------------------------------------------------------------


@dataclass
class _Profile:
    rows: list[np.ndarray]      # aligned byte rows (with gaps)
    seq_ids: list[int]          # input ordinal of each row
    pos_to_col: list[np.ndarray]  # per row: letter position -> column


def _leaf_profile(seq_bytes: np.ndarray, seq_id: int) -> _Profile:
    return _Profile(
        rows=[seq_bytes],
        seq_ids=[seq_id],
        pos_to_col=[np.arange(len(seq_bytes))],
    )


def _insert_gaps(row: np.ndarray, path: str, side: str) -> np.ndarray:
    out = np.empty(len(path), dtype=np.uint8)
    p = 0
    take = ("B", side)
    for k, c in enumerate(path):
        if c in take:
            out[k] = row[p]
            p += 1
        else:
            out[k] = GAP
    return out


def _profile_from_rows(rows, seq_ids) -> _Profile:
    pos_to_col = []
    for r in rows:
        pos_to_col.append(np.nonzero(r != GAP)[0])
    return _Profile(rows=list(rows), seq_ids=list(seq_ids), pos_to_col=pos_to_col)


def _align_profiles(p1: _Profile, p2: _Profile, posts: dict) -> _Profile:
    c1 = len(p1.rows[0])
    c2 = len(p2.rows[0])
    post = np.zeros((c1, c2), dtype=np.float32)
    for r1, s1 in enumerate(p1.seq_ids):
        cols1 = p1.pos_to_col[r1]
        for r2, s2 in enumerate(p2.seq_ids):
            cols2 = p2.pos_to_col[r2]
            if s1 < s2:
                Pm = posts[(s1, s2)]
                post[np.ix_(cols1, cols2)] += Pm
            else:
                Pm = posts[(s2, s1)]
                post[np.ix_(cols1, cols2)] += Pm.T
    _, path = mea_align(post)
    rows = [_insert_gaps(r, path, "X") for r in p1.rows] + [
        _insert_gaps(r, path, "Y") for r in p2.rows
    ]
    return _profile_from_rows(rows, p1.seq_ids + p2.seq_ids)


# ---------------------------------------------------------------------------
# Top-level MPC pipeline
# ---------------------------------------------------------------------------


def cluster_pairs(n: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def align(
    seqs: list[str],
    refine_iters: int = REFINE_ITERS,
    consistency_iters: int = CONSISTENCY_ITERS,
    seed: int = 0,
    pair_posts: list[np.ndarray] | None = None,
    hmm_params=None,
    tree_perm: str = "none",
    pair_dists: np.ndarray | None = None,
    use_native: bool = True,
    pair_posts_sparse=None,
) -> list[tuple[int, str]]:
    """Align sequences; returns [(input ordinal, aligned row)] in input
    order. Single sequence passes through unchanged.

    ``pair_posts`` optionally supplies precomputed match posteriors in
    cluster_pairs(n) order (the cross-cluster batched path of
    align_clusters); otherwise they are computed here. ``hmm_params``
    optionally overrides the pair-HMM tables (ensemble replicates).
    ``pair_dists`` optionally supplies the [n, n] EA distance matrix —
    required when ``pair_posts`` already had the consistency transform
    applied (EA distances come from the PRE-consistency posteriors,
    mpcflat.cpp CalcPosteriors -> m_DistMx).

    ``pair_posts_sparse`` optionally supplies the posteriors in the
    device top-k transport form instead: (vals [npair, L, K] f32,
    idx [npair, L, K] uint8 1-based, lx [npair] rows used). With the
    native library present they feed BuildPost directly (bit-identical,
    no densification); otherwise they are densified here. Requires
    ``pair_dists`` (the consistency transform is assumed applied or
    skipped upstream).
    """
    n = len(seqs)
    if n == 0:
        return []
    if n == 1:
        return [(0, seqs[0])]

    pairs = cluster_pairs(n)
    if pair_posts_sparse is not None:
        if pair_dists is None:
            raise ValueError("pair_posts_sparse requires pair_dists")
        from ... import native_lib

        if use_native and native_lib.available() and consistency_iters == 0:
            sv, si, slx = pair_posts_sparse
            joins = permute_join_order(upgma_join_order(pair_dists), tree_perm)
            if n >= 3 and refine_iters:
                rng = np.random.default_rng(seed)
                masks = rng.integers(0, 2, (refine_iters, n)).astype(np.uint8)
                keep = ~((masks.all(axis=1)) | (~masks.any(axis=1)))
                masks = masks[keep]
            else:
                masks = np.zeros((0, n), np.uint8)
            rows = native_lib.msa_progressive_refine_sparse_native(
                seqs, joins, sv, si, slx, masks, converge_after=5
            )
            return list(enumerate(rows))
        # no native library (or consistency still pending): densify
        from .pairhmm import densify_sparse

        sv, si, slx = pair_posts_sparse
        pair_posts = [
            densify_sparse(sv[p], si[p], int(slx[p]), len(seqs[j]))
            for p, (i, j) in enumerate(pairs)
        ]

    # 1. pair posteriors (batched pair HMM, on-device assembly) + EA dists
    if pair_posts is None:
        pair_posts = batch_posteriors(
            [seqs[i] for i, _ in pairs], [seqs[j] for _, j in pairs],
            params=hmm_params,
        )
    posts: dict[tuple[int, int], np.ndarray] = {}
    dist = np.zeros((n, n), dtype=np.float64)
    for p, (i, j) in enumerate(pairs):
        post = pair_posts[p]
        posts[(i, j)] = post
        if pair_dists is None:
            ea = mea_score(post) / min(len(seqs[i]), len(seqs[j]))
            dist[i, j] = dist[j, i] = 1.0 - min(max(ea, 0.0), 1.0)  # FixEADistMx
    if pair_dists is not None:
        dist = pair_dists

    # 2. consistency transform (skip for < 3 seqs, mpcflat.cpp:185-193)
    if n >= 3:
        for _ in range(consistency_iters):
            new_posts = {}
            for (i, j), Pij in posts.items():
                acc = 2.0 * Pij  # Z=X and Z=Y terms (conspairflat.cpp:29-31)
                for z in range(n):
                    if z == i or z == j:
                        continue
                    Piz = posts[(i, z)] if i < z else posts[(z, i)].T
                    Pzj = posts[(z, j)] if z < j else posts[(j, z)].T
                    acc = acc + Piz @ Pzj
                upd = acc / n
                # support limited to the old sparsity pattern
                # (UpdateFromPost keeps only existing entries)
                upd[Pij < MIN_SPARSE_PROB] = 0.0
                new_posts[(i, j)] = upd
            posts = new_posts

    # 3. guide tree + join order (+ optional ensemble tree permutation)
    joins = permute_join_order(upgma_join_order(dist), tree_perm)

    # 4+5 fast path: progressive alignment + refinement in native code
    # (bit-compatible; bipartition masks drawn HERE so the numpy RNG
    # stream matches the Python path exactly)
    from ... import native_lib

    if use_native and native_lib.available():
        if n >= 3 and refine_iters:
            rng = np.random.default_rng(seed)
            masks = rng.integers(0, 2, (refine_iters, n)).astype(np.uint8)
            keep = ~((masks.all(axis=1)) | (~masks.any(axis=1)))
            masks = masks[keep]
        else:
            masks = np.zeros((0, n), np.uint8)
        pair_list = [posts[p] for p in pairs]
        rows = native_lib.msa_progressive_refine_native(
            seqs, joins, pair_list, masks, converge_after=5
        )
        return list(enumerate(rows))

    # 4. progressive alignment
    nodes: dict[int, _Profile] = {
        i: _leaf_profile(np.frombuffer(seqs[i].encode("latin1"), np.uint8).copy(), i)
        for i in range(n)
    }
    next_id = n
    for a, b in joins:
        prof = _align_profiles(nodes.pop(a), nodes.pop(b), posts)
        nodes[next_id] = prof
        next_id += 1
    final = nodes[next_id - 1]

    # 5. refinement (skip for < 3 seqs, mpcflat.cpp:257-267). MUSCLE runs a
    # fixed 100 iterations; for the tiny, closely-related clusters of this
    # pipeline the alignment converges almost immediately, so we stop after
    # `converge_after` consecutive no-change iterations (a deviation from
    # the reference covered by the hard-output tolerance of SURVEY.md §7.5).
    if n >= 3 and refine_iters:
        rng = np.random.default_rng(seed)
        converge_after = 5
        unchanged = 0
        for _ in range(refine_iters):
            mask = rng.integers(0, 2, n).astype(bool)
            if mask.all() or not mask.any():
                continue
            g1 = [r for r, keep in enumerate(mask) if keep]
            g2 = [r for r, keep in enumerate(mask) if not keep]
            before = final
            final = _refine_split(final, g1, g2, posts)
            same = len(before.rows[0]) == len(final.rows[0]) and all(
                np.array_equal(a, b)
                for a, b in zip(
                    before.rows, (final.rows[final.seq_ids.index(s)] for s in before.seq_ids)
                )
            )
            unchanged = unchanged + 1 if same else 0
            if unchanged >= converge_after:
                break

    out = []
    order = np.argsort(final.seq_ids)
    for r in order:
        out.append((final.seq_ids[r], final.rows[r].tobytes().decode("latin1")))
    return out


def _project(profile: _Profile, row_ids: list[int]) -> _Profile:
    """Subset rows and drop all-gap columns (MultiSequence::Project)."""
    rows = [profile.rows[r] for r in row_ids]
    ids = [profile.seq_ids[r] for r in row_ids]
    mat = np.stack(rows)
    keep = ~(mat == GAP).all(axis=0)
    return _profile_from_rows([r[keep] for r in mat], ids)


def align_clusters(
    clusters: list[list[str]],
    refine_iters: int = REFINE_ITERS,
    consistency_iters: int = CONSISTENCY_ITERS,
    seed: int = 0,
    pair_chunk: int = 2048,
    n_workers: int | None = None,
    timings: dict | None = None,
) -> list[list[tuple[int, str]]]:
    """Align many clusters with the device stages batched ACROSS clusters.

    All C(k,2) pairs of every cluster are concatenated and swept through
    the antidiagonal pair-HMM DP in large fixed-size batches (one device
    dispatch per chunk instead of two per cluster); the consistency
    transform then runs as batched block matmuls over every cluster at
    once (ops/msa/consistency.py, replacing the per-pair host loop); the
    per-cluster tree / progressive / refine stages run on host with the
    precomputed posteriors. EA distances are computed from the
    PRE-consistency posteriors exactly as align() does (mpcflat.cpp
    CalcPosteriors -> m_DistMx). Results match per-cluster align().

    That is the CPU flow. On the GPU the device-resident flow runs
    instead (_align_clusters_device): chunk posteriors and EA scores come
    from the pair-HMM entry (pairhmm.batch_post_ea), and the consistency
    transform and the progressive/refine stages run on device.
    """
    import os

    import jax

    if timings is None:
        timings = {}
    platform = jax.default_backend()
    if platform == "gpu":
        # fully device-resident MSA; DNA_LDPC_DEVICE_MSA=0 selects the
        # sparse-transport flow feeding the host C++ aligner instead
        if os.environ.get("DNA_LDPC_DEVICE_MSA", "1") != "0":
            return _align_clusters_device(
                clusters, refine_iters, consistency_iters, seed, pair_chunk,
                n_workers, timings,
            )
        return _align_clusters_fused(
            clusters, refine_iters, consistency_iters, seed, pair_chunk,
            n_workers, timings,
        )
    if platform != "cpu":
        raise ValueError(f"no MSA flow for platform {platform!r}")
    from .consistency import consistency_clusters

    all_x: list[str] = []
    all_y: list[str] = []
    spans: list[tuple[int, int]] = []
    for seqs in clusters:
        pairs = cluster_pairs(len(seqs))
        start = len(all_x)
        all_x.extend(seqs[i] for i, _ in pairs)
        all_y.extend(seqs[j] for _, j in pairs)
        spans.append((start, len(all_x)))

    # pair-HMM chunks in the sparse transport form: the (vals, idx)
    # triplets are both densified on host for the host stages and
    # re-used AS-IS for the consistency transform (16-20x smaller than
    # dense, bit-identical values). ALL chunk jobs are dispatched
    # up-front and collected in order — every chunk's buffers are live
    # at once, which is fine at this path's scale (CPU runs and tests).
    from .pairhmm import batch_posteriors_sparse_start, densify_sparse

    import time as _time

    t_ph = _time.time()
    chunk_vals: list[np.ndarray] = []
    chunk_idx: list[np.ndarray] = []
    posts_flat: list[np.ndarray] = []
    jobs: list = []
    for lo in range(0, len(all_x), pair_chunk):
        cx, cy = all_x[lo : lo + pair_chunk], all_y[lo : lo + pair_chunk]
        # pad partial chunks up to pair_chunk with empty pairs so every
        # chunk reuses one compiled DP executable (shape-stable batching)
        npad = 0
        if len(cx) < pair_chunk and lo > 0:
            npad = pair_chunk - len(cx)
            cx = cx + [""] * npad
            cy = cy + [""] * npad
        jobs.append((batch_posteriors_sparse_start(cx, cy), len(cx) - npad))

    for ji in range(len(jobs)):
        job, P = jobs[ji]
        jobs[ji] = None  # release the device-side post tensor after collect
        vals, idx, lxs, lys, _L = job.collect()
        chunk_vals.append(vals[:P])
        chunk_idx.append(idx[:P])
        posts_flat.extend(
            densify_sparse(vals[p], idx[p], int(lxs[p]), int(lys[p]))
            for p in range(P)
        )

    def sparse_span(lo: int, hi: int):
        """Sparse rows for global pairs [lo, hi) across chunk boundaries."""
        vs, is_ = [], []
        while lo < hi:
            ci, off = divmod(lo, pair_chunk)
            take = min(hi - lo, len(chunk_vals[ci]) - off)
            vs.append(chunk_vals[ci][off : off + take])
            is_.append(chunk_idx[ci][off : off + take])
            lo += take
        # pad rows AND K (chunks re-sparsified by the losslessness guard
        # may carry K > top_k) to a common shape
        Lm = max(v.shape[1] for v in vs)
        Km = max(v.shape[2] for v in vs)
        vs = [
            np.pad(v, ((0, 0), (0, Lm - v.shape[1]), (0, Km - v.shape[2])))
            for v in vs
        ]
        is_ = [
            np.pad(i, ((0, 0), (0, Lm - i.shape[1]), (0, Km - i.shape[2])))
            for i in is_
        ]
        return np.concatenate(vs), np.concatenate(is_)

    timings["pairhmm"] = timings.get("pairhmm", 0.0) + (_time.time() - t_ph)

    # EA distances from the raw posteriors (before consistency); the
    # native MEA scorer releases the GIL, so clusters score in parallel
    import os
    from concurrent.futures import ThreadPoolExecutor

    if n_workers is None:
        n_workers = min(8, os.cpu_count() or 1)

    def ea_dist(args):
        seqs, (lo, hi) = args
        n = len(seqs)
        dist = np.zeros((n, n), dtype=np.float64)
        for p, (i, j) in enumerate(cluster_pairs(n)):
            ea = mea_score(posts_flat[lo + p]) / min(len(seqs[i]), len(seqs[j]))
            dist[i, j] = dist[j, i] = 1.0 - min(max(ea, 0.0), 1.0)
        return dist

    t_ea = _time.time()
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        dists = list(pool.map(ea_dist, zip(clusters, spans)))
    timings["ea"] = timings.get("ea", 0.0) + (_time.time() - t_ea)

    t_cons = _time.time()
    if consistency_iters:
        transformed = consistency_clusters(
            [posts_flat[lo:hi] for lo, hi in spans], iters=consistency_iters,
            cluster_sparse=[sparse_span(lo, hi) for lo, hi in spans],
        )
    else:
        transformed = [posts_flat[lo:hi] for lo, hi in spans]
    timings["consistency"] = timings.get("consistency", 0.0) + (_time.time() - t_cons)

    # tree + progressive + refine per cluster, thread-parallel (clusters
    # are independent; the hot DP runs in native code without the GIL)
    def align_one(args):
        seqs, posts, dist = args
        return align(
            seqs,
            refine_iters=refine_iters,
            consistency_iters=0,   # already applied, batched
            seed=seed,
            pair_posts=posts,
            pair_dists=dist,
        )

    t_prog = _time.time()
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        out = list(pool.map(align_one, zip(clusters, transformed, dists)))
    timings["progressive_refine"] = (
        timings.get("progressive_refine", 0.0) + (_time.time() - t_prog)
    )
    return out


def _refine_split(final: _Profile, g1, g2, posts) -> _Profile:
    # g1/g2 index into final's row order by *input ordinal*
    id_to_row = {sid: r for r, sid in enumerate(final.seq_ids)}
    p1 = _project(final, [id_to_row[s] for s in g1 if s in id_to_row])
    p2 = _project(final, [id_to_row[s] for s in g2 if s in id_to_row])
    return _align_profiles(p1, p2, posts)


def _align_clusters_device(
    clusters: list[list[str]],
    refine_iters: int,
    consistency_iters: int,
    seed: int,
    pair_chunk: int,
    n_workers: int | None,
    timings: dict | None = None,
) -> list[list[tuple[int, str]]]:
    """Fully device-resident align_clusters (the GPU production path).

    The posteriors NEVER leave the device (the fused flow below
    downloads every consistency-transformed posterior as a top-k sparse
    transport, ~380 MB/trial, for the host C++ progressive/refine
    stages):

    1. pair-HMM chunks (pairhmm.batch_post_ea) produce device-resident
       posteriors + MEA/EA scores — only the [P] scores download;
    2. clusters are grouped into device-MSA buckets
       (ops/msa/device_msa.MSA_BUCKETS) and, per super-batch,
       assemble_transform gathers their pairs from the chunk window,
       bf16-rounds them (the value set the sparse transport carried)
       and applies the consistency transform on device;
    3. run_msa_batch executes ALL progressive joins and refinement
       iterations as batched XLA merge programs; only the final uint8
       column maps (~2 MB/trial) are downloaded.

    Clusters larger than the top bucket or whose alignment overflows
    the device column budget fall back to the host align() path
    (posteriors recomputed — rare).  Semantics match the host path's
    merge machinery operation for operation; BuildPost float summation
    order differs (tests/test_device_msa.py).
    """
    import os
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from .device_msa import MSA_BUCKETS, assemble_transform, start_msa_batch
    from .pairhmm import batch_post_ea

    if timings is None:
        timings = {}

    def _tick(key: str, t0: float) -> float:
        now = _time.time()
        timings[key] = timings.get(key, 0.0) + (now - t0)
        return now

    n_cl = len(clusters)
    sizes = [len(c) for c in clusters]
    out: list = [None] * n_cl

    fallback: list[int] = []
    by_bucket: dict[int, list[int]] = {}
    maxlen = 1
    for c in range(n_cl):
        n = sizes[c]
        if n == 0:
            out[c] = []
            continue
        if n == 1:
            out[c] = [(0, clusters[c][0])]
        elif n > MSA_BUCKETS[-1]:
            fallback.append(c)
        else:
            nb = next(b for b in MSA_BUCKETS if b >= n)
            by_bucket.setdefault(nb, []).append(c)
            # only reads that reach the device pair/merge programs set
            # the padding (singleton and oversized-fallback clusters
            # never do, and must not inflate Lmax or trip its bound)
            maxlen = max(maxlen, max(len(s) for s in clusters[c]))

    Lmax = max(32, -(-maxlen // 32) * 32)
    if Lmax > 254:  # uint8 column-map transport bound
        return _align_clusters_fused(
            clusters, refine_iters, consistency_iters, seed, pair_chunk,
            n_workers, timings,
        )
    # pair layout: buckets ascending, clusters contiguous, so every
    # super-batch covers a contiguous global pair range and chunks can
    # be freed behind the frontier
    all_x: list[str] = []
    all_y: list[str] = []
    span: dict[int, tuple[int, int]] = {}
    for nb in sorted(by_bucket):
        for c in by_bucket[nb]:
            seqs = clusters[c]
            prs = cluster_pairs(len(seqs))
            s0 = len(all_x)
            all_x.extend(seqs[i] for i, _ in prs)
            all_y.extend(seqs[j] for _, j in prs)
            span[c] = (s0, len(all_x))
    ntot = len(all_x)
    ea_arr = np.zeros(max(ntot, 1), np.float32)
    chunk_cache: dict[int, object] = {}
    ea_pending: dict[int, object] = {}

    def get_chunk(ci):
        if ci in chunk_cache:
            return chunk_cache[ci]
        t0 = _time.time()
        lo = ci * pair_chunk
        cx = list(all_x[lo : lo + pair_chunk])
        cy = list(all_y[lo : lo + pair_chunk])
        npad = pair_chunk - len(cx)
        cx += [""] * npad
        cy += [""] * npad
        post, ea, _lx, _ly, _L = batch_post_ea(cx, cy, Lmax)
        ea_pending[ci] = ea  # downloaded lazily: the kernel dispatch
        # bf16 at rest: the assemble step rounds through bf16 anyway
        # (sparse-transport value parity) and it halves the window
        # concat the fixed-shape assemble program reads
        chunk_cache[ci] = post.astype(jnp.bfloat16)
        _tick("pairhmm", t0)
        return chunk_cache[ci]

    def ensure_ea():
        if not ea_pending:
            return
        # ONE stacked download for all pending chunks' EA scores
        cis = sorted(ea_pending)
        stacked = np.asarray(jnp.stack([ea_pending[ci] for ci in cis]))
        for k, ci in enumerate(cis):
            lo = ci * pair_chunk
            take = max(0, min(pair_chunk, ntot - lo))
            if take:
                ea_arr[lo : lo + take] = stacked[k, :take]
            del ea_pending[ci]

    # per-bucket cluster capacity: bounds the resident transformed-
    # posterior tensor to ~1.3 GB f32 (power of two for the chunked
    # BuildPost gather)
    # bounded by the bf16 Pblock tensors (up to ~1.7 GB per batch, TWO
    # batches in flight under the dispatch pipeline, plus build_pblock's
    # own intermediates of the same size)
    C_CAPS = {2: 4096, 4: 2048, 8: 512, 12: 256, 16: 128, 32: 16}

    def cluster_joins(c):
        seqs = clusters[c]
        n = len(seqs)
        d = np.zeros((n, n), dtype=np.float64)
        lo = span[c][0]
        for p, (i, j) in enumerate(cluster_pairs(n)):
            ea = float(ea_arr[lo + p]) / min(len(seqs[i]), len(seqs[j]))
            d[i, j] = d[j, i] = 1.0 - min(max(ea, 0.0), 1.0)  # FixEADistMx
        return upgma_join_order(d)

    # one super-batch stays in flight: the next batch's host work
    # (chunk encode, joins, mask tables) overlaps the previous batch's
    # device merges, and collect() happens while the device is busy
    pending: tuple | None = None

    def collect_job(p):
        batch, job = p
        t0 = _time.time()
        rows_out, _ovf = job.collect()
        for c, rows in zip(batch, rows_out):
            if rows is None:
                fallback.append(c)
            else:
                out[c] = rows
        _tick("msa_collect", t0)

    for nb in sorted(by_bucket):
        members = by_bucket[nb]
        npair_b = nb * (nb - 1) // 2
        ii_b, jj_b = np.triu_indices(nb, k=1)
        slot_of = {(int(a), int(b)): sl for sl, (a, b) in enumerate(zip(ii_b, jj_b))}
        C_cap = C_CAPS[nb]
        iters_b = consistency_iters if nb >= 3 else 0
        pf_cap = C_cap * npair_b
        K_b = pf_cap // pair_chunk + 2  # chunk window incl. misalignment
        n_chunks = max(1, -(-ntot // pair_chunk))
        for mlo in range(0, len(members), C_cap):
            batch = members[mlo : mlo + C_cap]
            p_lo = span[batch[0]][0]
            p_hi = span[batch[-1]][1]

            t0 = _time.time()
            ph_before = timings.get("pairhmm", 0.0)
            # FIXED-length chunk window per bucket (out-of-range slots
            # repeat the last chunk; their pair slots are masked) — one
            # compiled assemble program per bucket, trial-independent
            w0 = p_lo // pair_chunk
            chunks = tuple(
                get_chunk(min(w0 + k, n_chunks - 1)) for k in range(K_b)
            )
            ids = np.zeros(C_cap * npair_b, np.int32)
            mask = np.zeros(C_cap * npair_b, bool)
            inv_n = np.ones(C_cap, np.float32)
            for bi, c in enumerate(batch):
                n = sizes[c]
                inv_n[bi] = 1.0 / n
                lo_c = span[c][0]
                for pi, (i, j) in enumerate(cluster_pairs(n)):
                    sl = bi * npair_b + slot_of[(i, j)]
                    ids[sl] = lo_c + pi - w0 * pair_chunk
                    mask[sl] = True
            P = assemble_transform(
                chunks, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(inv_n),
                nb, iters_b, C_cap, Lmax,
            )
            del chunks
            # book the window sweep minus the chunk time get_chunk
            # already credited to "pairhmm" inside this interval
            timings["consistency"] = timings.get("consistency", 0.0) + (
                (_time.time() - t0) - (timings.get("pairhmm", 0.0) - ph_before)
            )
            # free chunks strictly behind the remaining pair frontier
            keep_from = p_hi // pair_chunk
            for ck in [k for k in list(chunk_cache) if k < keep_from]:
                del chunk_cache[ck]

            t0 = _time.time()
            ensure_ea()
            seqs_list = [clusters[c] for c in batch]
            joins_list = [cluster_joins(c) for c in batch]
            job = start_msa_batch(
                P, seqs_list, joins_list, nb, Lmax, refine_iters, seed,
            )
            del P
            _tick("msa_device", t0)
            if pending is not None:
                collect_job(pending)
            pending = (batch, job)
    if pending is not None:
        collect_job(pending)
    chunk_cache.clear()

    timings["host_fallback_clusters"] = timings.get("host_fallback_clusters", 0) + len(fallback)
    # host fallback: oversized clusters + device column-budget overflow.
    # Posteriors are computed here with the pair axis padded to a
    # multiple of 64 so odd cluster sizes reuse a handful of compiled
    # pair-HMM executables instead of one per size.
    if fallback:
        t0 = _time.time()
        if n_workers is None:
            n_workers = min(8, os.cpu_count() or 1)

        def full_align(c):
            seqs = clusters[c]
            prs = cluster_pairs(len(seqs))
            xs = [seqs[i] for i, _ in prs]
            ys = [seqs[j] for _, j in prs]
            from .pairhmm import batch_posteriors

            pad = -(-max(len(xs), 1) // 64) * 64
            posts = batch_posteriors(
                xs + [""] * (pad - len(xs)), ys + [""] * (pad - len(xs))
            )[: len(xs)]
            return align(
                clusters[c], refine_iters=refine_iters,
                consistency_iters=consistency_iters, seed=seed,
                pair_posts=posts,
            )

        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            for c, rows in zip(fallback, pool.map(full_align, fallback)):
                out[c] = rows
        _tick("progressive_refine", t0)
    return out


def _align_clusters_fused(
    clusters: list[list[str]],
    refine_iters: int,
    consistency_iters: int,
    seed: int,
    pair_chunk: int,
    n_workers: int | None,
    timings: dict | None = None,
) -> list[list[tuple[int, str]]]:
    """Device-fused align_clusters: pair posteriors stay ON DEVICE up to
    the consistency transform, and the host C++ aligner runs the
    progressive/refine stages on a top-k sparse download. Taken on the
    GPU when reads exceed the device MSA's 254-nt column maps or with
    DNA_LDPC_DEVICE_MSA=0.

    1. clusters are laid out pair-contiguously, RAW zone first (n == 2,
       n > max bucket, or consistency disabled — clusters whose
       posteriors must reach the host untransformed), then grouped by
       consistency bucket size;
    2. pair-HMM chunks (pairhmm.batch_post_ea) produce device-resident
       posteriors + MEA/EA scores (phase 3) — only the [P] scores are
       downloaded;
    3. the consistency transform gathers each bucket dispatch's pairs
       from the 2-chunk window covering its contiguous pair range
       (consistency._consistency_fused) and downloads only the final
       top-k transport;
    4. raw-zone chunks are top-k sparsified on device and downloaded
       once. Both downloads pass the bf16/top-k losslessness guard.

    Semantics match the host path (and per-cluster align()) exactly: the
    gathered posteriors are bf16-rounded on device to equal the sparse
    transport's values, and the phase-3 MEA scores are bitwise equal to
    host mea_score() on those values (f32 DP along identical paths).
    """
    import os
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from .consistency import N_BUCKETS, _consistency_fused, _consistency_host
    from .pairhmm import _sparsify_post, batch_post_ea, densify_sparse

    if timings is None:
        timings = {}

    def _tick(key: str, t0: float) -> float:
        now = _time.time()
        timings[key] = timings.get(key, 0.0) + (now - t0)
        return now

    n_cl = len(clusters)
    sizes = [len(c) for c in clusters]
    # every bucket dispatch's pair range must fit a 2-chunk device window
    # (ids are window-local), so the chunk must hold the largest bucket's
    # C(N_BUCKETS[-1], 2) pairs (496 at the current max bucket of 32 —
    # this floor is also the minimum device window)
    pair_chunk = max(pair_chunk, N_BUCKETS[-1] * (N_BUCKETS[-1] - 1) // 2)

    # ---- 1. processing order: raw zone, then buckets -------------------
    raw_ids: list[int] = []
    groups: dict[int, list[int]] = {}
    for c in range(n_cl):
        n = sizes[c]
        if n < 2:
            continue  # no pairs
        if consistency_iters == 0 or n == 2 or n > N_BUCKETS[-1]:
            raw_ids.append(c)
        else:
            nb = next(b for b in N_BUCKETS if b >= n)
            groups.setdefault(nb, []).append(c)
    ordered = raw_ids + [c for nb in sorted(groups) for c in groups[nb]]

    all_x: list[str] = []
    all_y: list[str] = []
    span: dict[int, tuple[int, int]] = {}
    for c in ordered:
        seqs = clusters[c]
        prs = cluster_pairs(len(seqs))
        s0 = len(all_x)
        all_x.extend(seqs[i] for i, _ in prs)
        all_y.extend(seqs[j] for _, j in prs)
        span[c] = (s0, len(all_x))
    ntot = len(all_x)
    nraw = span[raw_ids[-1]][1] if raw_ids else 0

    # ---- 2-4. memory-bounded device pipeline ---------------------------
    # Chunk posteriors are LAZY and freed behind the dispatch frontier:
    # the pair layout makes every dispatch's 2-chunk window ascend
    # monotonically, so at most MAX_LIVE chunks (~1.9 GB at Lmax=160)
    # are device-resident regardless of trial size — a double-coverage
    # (140k-read) trial exhausted HBM when all chunks stayed alive.
    maxlen = max((len(s) for s in all_x + all_y), default=1)
    Lmax = max(32, -(-maxlen // 32) * 32)
    if Lmax > 255:
        raise ValueError(
            "the fused align_clusters flow uses the uint8 sparse transport "
            f"(Lmax <= 255); got padded Lmax={Lmax}"
        )
    lx_all = np.array([len(s) for s in all_x], np.int32)
    ly_all = np.array([len(s) for s in all_y], np.int32)
    n_chunks = max(1, -(-ntot // pair_chunk))
    MAX_LIVE = 8

    # host-side dispatch plan, in ascending window order (the order of
    # ``ordered``): raw-zone chunk sparsifications, then bucket batches
    plan: list[tuple] = []
    if nraw:
        for ci in range(-(-nraw // pair_chunk)):
            plan.append(("raw", ci))
    for nb in sorted(groups):
        members = groups[nb]
        npair_b = nb * (nb - 1) // 2
        ii_b, jj_b = np.triu_indices(nb, k=1)
        slot_of = {(int(a), int(b)): sl for sl, (a, b) in enumerate(zip(ii_b, jj_b))}
        C_b = max(1, pair_chunk // npair_b)
        for mlo in range(0, len(members), C_b):
            batch = members[mlo : mlo + C_b]
            g0 = span[batch[0]][0]
            w = g0 // pair_chunk
            ids = np.zeros(C_b * npair_b, np.int32)
            mask = np.zeros(C_b * npair_b, bool)
            inv_n = np.ones(C_b, np.float32)
            for bi, c in enumerate(batch):
                n = sizes[c]
                inv_n[bi] = 1.0 / n
                lo_c = span[c][0]
                for pi, (i, j) in enumerate(cluster_pairs(n)):
                    sl = bi * npair_b + slot_of[(i, j)]
                    ids[sl] = lo_c + pi - w * pair_chunk
                    mask[sl] = True
            plan.append(("bucket", batch, slot_of, ids, mask, inv_n, nb, w))

    chunk_cache: dict[int, object] = {}
    ea_arr = np.zeros(max(ntot, 1), np.float32)

    def get_chunk(ci):
        if ci in chunk_cache:
            return chunk_cache[ci]
        t0 = _time.time()
        lo = ci * pair_chunk
        cx = list(all_x[lo : lo + pair_chunk])
        cy = list(all_y[lo : lo + pair_chunk])
        npad = pair_chunk - len(cx)
        cx += [""] * npad
        cy += [""] * npad
        post, ea, _lx, _ly, _L = batch_post_ea(cx, cy, Lmax)
        take = max(0, min(pair_chunk, ntot - lo))
        if take:
            ea_arr[lo : lo + take] = np.asarray(ea)[:take]
        chunk_cache[ci] = post
        _tick("pairhmm", t0)
        return post

    raw_chunks: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    # transformed[c] = ("sparse", vals, idx, lx) or ("dense", posts list)
    transformed: dict[int, tuple] = {}
    pending: list[tuple] = []

    def collect_pending():
        for item in pending:
            if item[0] == "raw":
                _, ci, vals, idx, msup = item
                k = int(msup)
                if k > 8:  # lossless guard
                    vals, idx, _ = _sparsify_post(chunk_cache[ci], k)
                raw_chunks[ci] = (np.asarray(vals, np.float32), np.asarray(idx))
                continue
            _, batch, slot_of, args, vals, idx, msup = item
            k = int(msup)
            if k > 8:  # lossless guard; round up to bound recompiles
                k = -(-k // 8) * 8
                vals, idx, _ = _consistency_fused(*args, k)
            vals = np.asarray(vals, np.float32)
            idx = np.asarray(idx)
            for bi, c in enumerate(batch):
                seqs = clusters[c]
                n = sizes[c]
                slots = [slot_of[(i, j)] for (i, j) in cluster_pairs(n)]
                slx = np.array([len(seqs[i]) for i, _ in cluster_pairs(n)], np.int32)
                transformed[c] = ("sparse", vals[bi, slots], idx[bi, slots], slx)
        pending.clear()

    t_cons = _time.time()
    ph_before = timings.get("pairhmm", 0.0)
    for d in plan:
        if d[0] == "raw":
            ci = d[1]
            vals, idx, msup = _sparsify_post(get_chunk(ci), 8)
            pending.append(("raw", ci, vals, idx, msup))
            w_cur = ci
        else:
            _, batch, slot_of, ids, mask, inv_n, nb, w = d
            chunkA = get_chunk(w)
            chunkB = get_chunk(w + 1) if w + 1 < n_chunks else chunkA
            args = (
                chunkA, chunkB, jnp.asarray(ids), jnp.asarray(mask),
                jnp.asarray(inv_n), nb, consistency_iters,
            )
            vals, idx, msup = _consistency_fused(*args, 8)
            pending.append(("bucket", batch, slot_of, args, vals, idx, msup))
            w_cur = w
        if len(chunk_cache) > MAX_LIVE:
            collect_pending()  # before eviction: overflow redos need the chunks
            for ci in [k for k in list(chunk_cache) if k < w_cur]:
                del chunk_cache[ci]
    collect_pending()
    chunk_cache.clear()
    # consistency time = plan sweep minus the pair-HMM chunk time booked
    # inside get_chunk calls made from this loop
    timings["consistency"] = timings.get("consistency", 0.0) + (
        (_time.time() - t_cons) - (timings.get("pairhmm", 0.0) - ph_before)
    )

    def raw_span_sparse(lo, hi):
        """Sparse (vals, idx) rows for global raw pairs [lo, hi), padded
        to a common K across chunk boundaries."""
        vs, is_ = [], []
        g = lo
        while g < hi:
            ci, off = divmod(g, pair_chunk)
            take = min(hi - g, pair_chunk - off)
            cv, cidx = raw_chunks[ci]
            vs.append(cv[off : off + take])
            is_.append(cidx[off : off + take])
            g += take
        Km = max(v.shape[2] for v in vs)
        vs = [np.pad(v, ((0, 0), (0, 0), (0, Km - v.shape[2]))) for v in vs]
        is_ = [np.pad(i, ((0, 0), (0, 0), (0, Km - i.shape[2]))) for i in is_]
        return np.concatenate(vs), np.concatenate(is_)

    # ---- EA distances (FixEADistMx) ------------------------------------
    dists: dict[int, np.ndarray] = {}
    for c in range(n_cl):
        seqs = clusters[c]
        n = len(seqs)
        d = np.zeros((n, n), dtype=np.float64)
        if n >= 2:
            lo = span[c][0]
            for p, (i, j) in enumerate(cluster_pairs(n)):
                ea = float(ea_arr[lo + p]) / min(len(seqs[i]), len(seqs[j]))
                d[i, j] = d[j, i] = 1.0 - min(max(ea, 0.0), 1.0)
        dists[c] = d

    # ---- raw clusters: sparse pass-through or host consistency ---------
    for c in raw_ids:
        lo, hi = span[c]
        n = sizes[c]
        if consistency_iters and n > N_BUCKETS[-1]:
            # host consistency needs dense posts (rare: n > max bucket)
            sv, si = raw_span_sparse(lo, hi)
            posts = [
                densify_sparse(sv[g - lo], si[g - lo], int(lx_all[g]), int(ly_all[g]))
                for g in range(lo, hi)
            ]
            transformed[c] = ("dense", _consistency_host(posts, n, consistency_iters))
        else:
            sv, si = raw_span_sparse(lo, hi)
            transformed[c] = ("sparse", sv, si, lx_all[lo:hi])
    del raw_chunks

    # ---- 5. tree + progressive + refine per cluster --------------------
    if n_workers is None:
        n_workers = min(8, os.cpu_count() or 1)

    def align_one(c):
        entry = transformed.get(c)
        kw = {}
        if entry is not None and entry[0] == "sparse":
            kw["pair_posts_sparse"] = (entry[1], entry[2], entry[3])
        elif entry is not None:
            kw["pair_posts"] = entry[1]
        return align(
            clusters[c],
            refine_iters=refine_iters,
            consistency_iters=0,  # applied above (or skipped: n < 3)
            seed=seed,
            pair_dists=dists[c],
            **kw,
        )

    t_prog = _time.time()
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        out = list(pool.map(align_one, range(n_cl)))
    _tick("progressive_refine", t_prog)
    return out
