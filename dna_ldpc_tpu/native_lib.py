"""Build/load the native host-side ingest library (native/ingest.cpp).

The shared object is compiled on first use with g++ -O3 into the
checkout's ``build/`` directory and bound via ctypes (no pybind11 dependency). Every entry point
has a pure-numpy fallback with identical semantics, so the framework works
without a toolchain; the native path accelerates trial ingest (per-cluster
LLR counting and the edit-distance pre-filter).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "native", "ingest.cpp")
_lib = None
_lib_tried = False


def _build_and_load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    cache_dir = os.path.join(os.path.dirname(src), "..", "build")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "ingest.so")
    try:
        if (not os.path.exists(so_path)) or os.path.getmtime(so_path) < os.path.getmtime(src):
            with tempfile.TemporaryDirectory() as td:
                tmp = os.path.join(td, "ingest.so")
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", tmp],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
    except (OSError, subprocess.CalledProcessError):
        return None

    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.count_trial_llrs.argtypes = [
        i8p, i64p, i32p, i64p, i64p, i64p, i32p,
        ctypes.c_int64, ctypes.c_double, f64p, i32p,
    ]
    lib.edit_distance_batch.argtypes = [i8p, i64p, i32p, i32p, i32p, ctypes.c_int64, i32p]
    f32p = ctypes.POINTER(ctypes.c_float)
    charp = ctypes.c_char_p
    lib.mea_align.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, charp, charp, i32p, f32p]
    lib.mea_score.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, f32p]
    lib.merge_overlap_batch.argtypes = [
        i8p, i8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i64p, i64p,
    ]
    lib.msa_progressive_refine.argtypes = [
        i8p, i64p, i32p, ctypes.c_int32,       # seqs
        i32p,                                   # joins
        f32p, i64p, i32p, i32p,                 # posts
        i8p, ctypes.c_int32, ctypes.c_int32,    # masks
        i8p, ctypes.c_int32, i32p,              # out
    ]
    lib.msa_progressive_refine_sp.argtypes = [
        i8p, i64p, i32p, ctypes.c_int32,       # seqs
        i32p,                                   # joins
        f32p, i8p, i64p, i32p, ctypes.c_int32,  # sparse posts (vals/idx/off/rows/K)
        i8p, ctypes.c_int32, ctypes.c_int32,    # masks
        i8p, ctypes.c_int32, i32p,              # out
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _build_and_load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def count_trial_llrs_native(
    bytes_buf: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    quals: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    strand_of_cluster: np.ndarray,
    mag: float,
    llr_out: np.ndarray,
) -> np.ndarray:
    """Returns per-cluster status (0 = counted natively, 1 = needs the
    Python/MSA path). llr_out [18432, 272] is written in place."""
    lib = _build_and_load()
    assert lib is not None
    n = len(starts)
    status = np.zeros(n, dtype=np.int32)
    lib.count_trial_llrs(
        _ptr(bytes_buf, ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int32),
        _ptr(quals, ctypes.c_int64),
        _ptr(starts, ctypes.c_int64),
        _ptr(ends, ctypes.c_int64),
        _ptr(strand_of_cluster, ctypes.c_int32),
        ctypes.c_int64(n),
        ctypes.c_double(mag),
        _ptr(llr_out, ctypes.c_double),
        _ptr(status, ctypes.c_int32),
    )
    return status


def edit_distance_batch_native(
    bytes_buf: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    pairs_a: np.ndarray,
    pairs_b: np.ndarray,
    n_threads: int | None = None,
) -> np.ndarray:
    """Pairs are split across OS threads (ctypes releases the GIL during
    the native call, and each pair's DP is independent)."""
    lib = _build_and_load()
    assert lib is not None
    pa = np.ascontiguousarray(pairs_a, np.int32)
    pb = np.ascontiguousarray(pairs_b, np.int32)
    n = len(pa)
    out = np.zeros(n, dtype=np.int32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)

    def run(lo: int, hi: int) -> None:
        if hi <= lo:
            return
        lib.edit_distance_batch(
            _ptr(bytes_buf, ctypes.c_uint8),
            _ptr(offsets, ctypes.c_int64),
            _ptr(lengths, ctypes.c_int32),
            _ptr(pa[lo:hi], ctypes.c_int32),
            _ptr(pb[lo:hi], ctypes.c_int32),
            ctypes.c_int64(hi - lo),
            _ptr(out[lo:hi], ctypes.c_int32),
        )

    if n_threads <= 1 or n < 2048:
        run(0, n)
        return out
    from concurrent.futures import ThreadPoolExecutor

    step = -(-n // n_threads)
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(lambda lo: run(lo, min(lo + step, n)), range(0, n, step)))
    return out


def mea_align_native(post: np.ndarray) -> tuple[float, str]:
    """Native MEA DP + traceback; post: [LX, LY] float32 C-contiguous."""
    lib = _build_and_load()
    assert lib is not None
    post = np.ascontiguousarray(post, np.float32)
    LX, LY = post.shape
    tb = ctypes.create_string_buffer((LX + 1) * (LY + 1))
    path = ctypes.create_string_buffer(LX + LY + 1)
    n = np.zeros(1, np.int32)
    score = np.zeros(1, np.float32)
    lib.mea_align(
        _ptr(post, ctypes.c_float), ctypes.c_int32(LX), ctypes.c_int32(LY),
        tb, path, _ptr(n, ctypes.c_int32), _ptr(score, ctypes.c_float),
    )
    return float(score[0]), path.raw[: int(n[0])].decode()


def mea_score_native(post: np.ndarray) -> float:
    lib = _build_and_load()
    assert lib is not None
    post = np.ascontiguousarray(post, np.float32)
    LX, LY = post.shape
    score = np.zeros(1, np.float32)
    lib.mea_score(_ptr(post, ctypes.c_float), ctypes.c_int32(LX), ctypes.c_int32(LY),
                  _ptr(score, ctypes.c_float))
    return float(score[0])


def merge_overlap_batch_native(
    m1: np.ndarray, m2: np.ndarray, l1: np.ndarray, l2: np.ndarray, min_overlap: int
) -> tuple[np.ndarray, np.ndarray]:
    """Best-overlap scoring for paired-end merging (pipeline/ingest.py):
    returns (best_o, best_mm) per pair. m1/m2: [n, L] uint8 C-contiguous
    (m2 already reverse-complemented)."""
    lib = _build_and_load()
    assert lib is not None
    m1 = np.ascontiguousarray(m1, np.uint8)
    m2 = np.ascontiguousarray(m2, np.uint8)
    l1 = np.ascontiguousarray(l1, np.int64)
    l2 = np.ascontiguousarray(l2, np.int64)
    n, L = m1.shape
    best_o = np.zeros(n, np.int64)
    best_mm = np.zeros(n, np.int64)
    lib.merge_overlap_batch(
        _ptr(m1, ctypes.c_uint8), _ptr(m2, ctypes.c_uint8),
        _ptr(l1, ctypes.c_int64), _ptr(l2, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_int64(L), ctypes.c_int32(min_overlap),
        _ptr(best_o, ctypes.c_int64), _ptr(best_mm, ctypes.c_int64),
    )
    return best_o, best_mm


def msa_progressive_refine_native(
    seqs: list[str],
    joins: list[tuple[int, int]],
    pair_posts: list[np.ndarray],
    masks: np.ndarray,
    converge_after: int,
) -> list[str]:
    """Progressive alignment + refinement of one cluster in native code
    (MUSCLE ProgressiveAlign/RefineIter; bit-compatible with the Python
    path in ops/msa/align.py). ``masks``: [iters, n] uint8 bipartitions
    with all-same rows already removed. Returns aligned rows in input
    (seq-id) order."""
    lib = _build_and_load()
    assert lib is not None
    n = len(seqs)
    seq_bytes = [s.encode("latin1") for s in seqs]
    lens = np.array([len(b) for b in seq_bytes], np.int32)
    offs = np.zeros(n, np.int64)
    offs[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    buf = np.frombuffer(b"".join(seq_bytes), np.uint8).copy()

    joins_arr = np.asarray(joins, np.int32).reshape(-1)
    posts = [np.ascontiguousarray(p, np.float32) for p in pair_posts]
    post_r = np.array([p.shape[0] for p in posts], np.int32)
    post_c = np.array([p.shape[1] for p in posts], np.int32)
    sizes = post_r.astype(np.int64) * post_c
    post_off = np.zeros(len(posts), np.int64)
    post_off[1:] = np.cumsum(sizes[:-1])
    post_buf = (
        np.concatenate([p.reshape(-1) for p in posts])
        if posts else np.zeros(0, np.float32)
    )

    masks = np.ascontiguousarray(masks, np.uint8)
    out_cap = int(lens.sum()) + 8
    out_buf = np.zeros((n, out_cap), np.uint8)
    out_cols = np.zeros(1, np.int32)
    lib.msa_progressive_refine(
        _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(lens, ctypes.c_int32), ctypes.c_int32(n),
        _ptr(joins_arr, ctypes.c_int32),
        _ptr(post_buf, ctypes.c_float), _ptr(post_off, ctypes.c_int64),
        _ptr(post_r, ctypes.c_int32), _ptr(post_c, ctypes.c_int32),
        _ptr(masks, ctypes.c_uint8), ctypes.c_int32(masks.shape[0] if masks.size else 0),
        ctypes.c_int32(converge_after),
        _ptr(out_buf, ctypes.c_uint8), ctypes.c_int32(out_cap),
        _ptr(out_cols, ctypes.c_int32),
    )
    cols = int(out_cols[0])
    assert cols > 0, "native alignment overflowed its output buffer"
    return [out_buf[i, :cols].tobytes().decode("latin1") for i in range(n)]


def msa_progressive_refine_sparse_native(
    seqs: list[str],
    joins: list[tuple[int, int]],
    sparse_vals: np.ndarray,   # [npair, Lmax, K] f32 (bf16-representable)
    sparse_idx: np.ndarray,    # [npair, Lmax, K] uint8, 1-based, 0 = pruned
    lx: np.ndarray,            # [npair] rows actually used per pair
    masks: np.ndarray,
    converge_after: int,
) -> list[str]:
    """Progressive alignment + refinement consuming the device top-k
    sparse transport DIRECTLY — no host densification. Bit-identical to
    msa_progressive_refine_native on the densified posteriors: within a
    pair every sparse entry hits a distinct BuildPost accumulator cell,
    so only the (r1, r2) profile-row loop order matters and it is
    unchanged."""
    lib = _build_and_load()
    assert lib is not None
    n = len(seqs)
    seq_bytes = [s.encode("latin1") for s in seqs]
    lens = np.array([len(b) for b in seq_bytes], np.int32)
    offs = np.zeros(n, np.int64)
    offs[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    buf = np.frombuffer(b"".join(seq_bytes), np.uint8).copy()

    joins_arr = np.asarray(joins, np.int32).reshape(-1)
    npair, Lmax, K = sparse_vals.shape
    post_r = np.ascontiguousarray(lx, np.int32)
    # flatten per pair to rows-used x K (contiguous per pair)
    sv_parts = [np.ascontiguousarray(sparse_vals[p, : post_r[p]], np.float32)
                for p in range(npair)]
    si_parts = [np.ascontiguousarray(sparse_idx[p, : post_r[p]], np.uint8)
                for p in range(npair)]
    sizes = post_r.astype(np.int64) * K
    post_off = np.zeros(npair, np.int64)
    post_off[1:] = np.cumsum(sizes[:-1])
    sv = (np.concatenate([a.reshape(-1) for a in sv_parts])
          if npair else np.zeros(0, np.float32))
    si = (np.concatenate([a.reshape(-1) for a in si_parts])
          if npair else np.zeros(0, np.uint8))

    masks = np.ascontiguousarray(masks, np.uint8)
    out_cap = int(lens.sum()) + 8
    out_buf = np.zeros((n, out_cap), np.uint8)
    out_cols = np.zeros(1, np.int32)
    lib.msa_progressive_refine_sp(
        _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(lens, ctypes.c_int32), ctypes.c_int32(n),
        _ptr(joins_arr, ctypes.c_int32),
        _ptr(sv, ctypes.c_float), _ptr(si, ctypes.c_uint8),
        _ptr(post_off, ctypes.c_int64), _ptr(post_r, ctypes.c_int32),
        ctypes.c_int32(K),
        _ptr(masks, ctypes.c_uint8), ctypes.c_int32(masks.shape[0] if masks.size else 0),
        ctypes.c_int32(converge_after),
        _ptr(out_buf, ctypes.c_uint8), ctypes.c_int32(out_cap),
        _ptr(out_cols, ctypes.c_int32),
    )
    cols = int(out_cols[0])
    assert cols > 0, "native alignment overflowed its output buffer"
    return [out_buf[i, :cols].tobytes().decode("latin1") for i in range(n)]
