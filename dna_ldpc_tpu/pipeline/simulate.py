"""Sequencing-read simulator: synthesizes trials from the encoded oligo
pool for end-to-end testing and FER/cost studies.

The reference bundles real sampled-read files (``72000_RS_<t>.txt``, large
blobs) produced upstream by FLASH-merging Illumina FASTQs; those artifacts
are not re-derivable from the repo. This simulator plays the channel's
role instead: sample oligos with a coverage distribution, apply
substitution/insertion/deletion noise per base, and emit one quality
character per read (the reference's quality files carry exactly one char
per read, ``72000_RS_Q_*`` / decoder.py:54,90). It doubles as the
pipeline-level fault-injection hook (the analogue of the decoder-level
channels in ``LDPC_dec/ldpc/channel.cpp``, see ops/channels.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import dna


@dataclass
class ChannelModel:
    """Per-base error rates. Defaults are calibrated to the regime the
    reference pipeline actually tolerates: its LLR rules keep only MSA
    rows whose aligned width is exactly 136 (decoder.py:209-233), so ANY
    cluster containing an insertion read (aligned width >= 137) becomes
    an all-but-bit-271 erasure. The real dataset is deletion-dominant
    (variable-length reads are the paper's premise); at Illumina-like
    insertion rates (~1e-5/nt) insertion-erased clusters stay rare enough
    for BP to absorb. Raising ``insertion`` toward ``deletion`` is a
    fault-injection knob, not a realistic channel."""

    substitution: float = 0.01
    insertion: float = 2e-5
    deletion: float = 5e-4
    # quality chars: high-quality reads get > '?' (63), low-quality < '5' (53)
    q_high: int = 70
    q_low: int = 40
    p_low_quality: float = 0.05


def load_oligos(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def simulate_reads(
    oligos: list[str],
    n_reads: int,
    channel: ChannelModel = ChannelModel(),
    seed: int = 0,
) -> tuple[list[str], list[str]]:
    """Sample n_reads uniformly from the oligo pool through the noisy
    channel. Returns (reads, quality_chars).

    Vectorized over the whole batch: substitutions are applied as one
    masked matrix update; only reads that actually draw an indel (a few
    percent at the calibrated rates) take a per-read slow path."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(oligos), size=n_reads)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    pool = dna.seqs_to_matrix(oligos)          # [n_oligos, L] uint8
    L = pool.shape[1]
    seqs = pool[picks].copy()                  # [n_reads, L]

    # substitutions: replace with one of the three other bases
    sub_mask = rng.random(seqs.shape) < channel.substitution
    if sub_mask.any():
        r, c = np.nonzero(sub_mask)
        offs = rng.integers(1, 4, size=len(r))
        cur = dna.dna_to_symbols(seqs[r, c])
        seqs[r, c] = bases[(cur + offs) % 4]

    del_mask = rng.random(seqs.shape) < channel.deletion
    # one insertion slot before each base plus one at the end
    ins_mask = rng.random((n_reads, L + 1)) < channel.insertion
    ins_base = bases[rng.integers(0, 4, size=(n_reads, L + 1))]
    has_indel = del_mask.any(axis=1) | ins_mask.any(axis=1)

    reads: list[str] = [""] * n_reads
    clean = np.nonzero(~has_indel)[0]
    for i in clean:
        reads[i] = seqs[i].tobytes().decode("ascii")
    for i in np.nonzero(has_indel)[0]:
        seq = seqs[i][~del_mask[i]]
        im = ins_mask[i][np.concatenate([~del_mask[i], [True]])]
        if im.any():
            ib = ins_base[i][np.concatenate([~del_mask[i], [True]])]
            out = np.empty(len(seq) + int(im.sum()), np.uint8)
            # positions shift right by the number of insertions at or
            # before each slot
            shift = np.cumsum(im)
            out[np.nonzero(im)[0] + shift[im] - 1] = ib[im]
            pos = np.arange(len(seq)) + shift[:-1][np.arange(len(seq))]
            out[pos] = seq
            seq = out
        reads[i] = seq.tobytes().decode("ascii")

    qv = np.where(
        rng.random(n_reads) < channel.p_low_quality, channel.q_low, channel.q_high
    ).astype(np.uint8)
    quals = [chr(q) for q in qv]
    return reads, quals


# ---------------------------------------------------------------------------
# Seeded synthetic pool (oracle codewords + encoded oligos)
# ---------------------------------------------------------------------------


def strand_index_dna() -> np.ndarray:
    """[18432, 16] uint8 DNA bytes: the RS(8,4)-encoded 16-nt index prefix
    of every strand, built with the same conventions rs_filter_reads
    decodes (rs_dec_init.m bit packing; decoder.py:59-64)."""
    from ..models.codebook import index_codebook
    from ..models.rs_index import rs_encode

    vals = index_codebook()                                   # rank -> 16-bit value
    msg_bits = dna.int_to_bits_msb(vals, 16)                  # [S, 16]
    syms = msg_bits.reshape(-1, 4, 4) @ (1 << np.arange(3, -1, -1))
    cw = rs_encode(syms)                                      # [S, 8] GF(16)
    bits32 = dna.int_to_bits_msb(cw, 4).reshape(-1, 32)
    return dna.bits_to_dna(bits32)                            # [S, 16]


def oligos_from_codewords(codewords: np.ndarray) -> list[str]:
    """Strand s = RS index prefix + column s of the [272, 18432]
    codeword matrix as 136 nt (two bits per base): 152-nt oligos."""
    payload = dna.bits_to_dna(codewords.T.astype(np.uint8))   # [S, 136]
    pool = np.concatenate([strand_index_dna(), payload], axis=1)
    return [row.tobytes().decode("ascii") for row in pool]


def synthetic_pool(seed: int = 0) -> tuple[np.ndarray, list[str]]:
    """A seeded stand-in for the shipped pool: 272 random messages
    encoded by ``sparse_encode`` on the deployed 2048 x 18432 code.
    Returns (oracle codewords [272, 18432] uint8, 18,432 oligos)."""
    from ..models.codebook import PAYLOAD_BITS
    from ..models.rs_ldpc import dna_storage_pchk
    from ..models.sparse_lu import lu_decompose, sparse_encode

    lu = lu_decompose(dna_storage_pchk())
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (PAYLOAD_BITS, len(lu.info_cols)), dtype=np.uint8)
    codewords = sparse_encode(lu, msgs)
    return codewords, oligos_from_codewords(codewords)


def trial_like_llrs(
    codewords: np.ndarray, seed: int = 0, coverage: float = 3.7, eps: float = 0.02
) -> np.ndarray:
    """[B, N] float32 BP inputs shaped like a trial's soft information:
    per-strand coverage ~ Poisson(coverage), per-read bit error ``eps``,
    LLR = (agreeing - disagreeing reads) * log((1-eps)/eps), signed by
    the codeword bits (LLR >= 0 <=> bit 0)."""
    rng = np.random.default_rng(seed)
    cov = rng.poisson(coverage, codewords.shape)
    errs = rng.binomial(cov, eps)
    mag = np.log((1 - eps) / eps)
    sign = 1.0 - 2.0 * codewords.astype(np.float32)
    return ((cov - 2 * errs) * mag * sign).astype(np.float32)


# ---------------------------------------------------------------------------
# Calibration against the shipped per-trial quality files
# ---------------------------------------------------------------------------

REFERENCE_Q_DIR = "/root/reference/ex_decoder"


@dataclass(frozen=True)
class QualityModel:
    """Empirical per-read quality-character distribution, fit from the
    reference's shipped ``72000_RS_Q_<t>.txt`` files (one char per read,
    67,926-67,981 lines/trial; decoder.py:54,90). The real distribution
    is ~88% 'C' (Q34) with a tail crossing both decision thresholds the
    LLR rules use ('5'=53 and '?'=63): ~1.3% below 53, ~3.0% in 53..63,
    ~95.7% above — the parametric two-point model in ChannelModel is
    replaced by this when calibration data is available."""

    chars: tuple            # uint8 codes
    probs: tuple            # matching probabilities

    @classmethod
    def from_counts(cls, counts: dict) -> "QualityModel":
        total = sum(counts.values())
        items = sorted(counts.items())
        return cls(
            chars=tuple(ord(k) for k, _ in items),
            probs=tuple(v / total for _, v in items),
        )

    @classmethod
    def from_reference(cls, path: str) -> "QualityModel":
        counts: dict = {}
        with open(path) as f:
            for line in f:
                q = line.rstrip("\n")
                if q:
                    counts[q] = counts.get(q, 0) + 1
        return cls.from_counts(counts)

    def sample(self, rng: np.random.Generator, n: int) -> list[str]:
        codes = rng.choice(
            np.asarray(self.chars, np.uint8), size=n, p=np.asarray(self.probs)
        )
        return [chr(c) for c in codes]


import functools as _functools
import os as _os


@_functools.lru_cache(maxsize=1)
def reference_quality_model(q_dir: str = REFERENCE_Q_DIR) -> "QualityModel | None":
    """Aggregate quality model over every shipped trial's Q file (their
    distributions agree to ~0.1%, so pooling is sound); None when the
    reference checkout is absent."""
    counts: dict = {}
    found = False
    for t in range(10):
        path = _os.path.join(q_dir, f"72000_RS_Q_{t}.txt")
        if not _os.path.isfile(path):
            continue
        found = True
        with open(path) as f:
            for line in f:
                q = line.rstrip("\n")
                if q:
                    counts[q] = counts.get(q, 0) + 1
    return QualityModel.from_counts(counts) if found else None


@_functools.lru_cache(maxsize=16)
def reference_read_count(trial: int, q_dir: str = REFERENCE_Q_DIR) -> int | None:
    """Reads in the shipped trial = the Q file's line count (67,926-67,981
    of the 72,000 sampled; the shortfall is upstream FLASH-merge loss)."""
    path = _os.path.join(q_dir, f"72000_RS_Q_{trial}.txt")
    if not _os.path.isfile(path):
        return None
    with open(path) as f:
        return sum(1 for _ in f)


def simulate_trial(
    oligos: list[str],
    trial: int,
    channel: ChannelModel = ChannelModel(),
    seed: int | None = None,
) -> tuple[list[str], list[str]]:
    """Simulate one reference-shaped trial: the read COUNT comes from the
    shipped trial's Q file and the quality characters are drawn from the
    pooled empirical distribution (both fall back to the parametric
    model without a reference checkout). Error rates keep ChannelModel's
    documented calibration — the read blobs themselves are missing
    upstream, so per-base rates are not observable."""
    n = reference_read_count(trial) or 70000
    reads, quals = simulate_reads(
        oligos, n, channel, seed=trial if seed is None else seed
    )
    qm = reference_quality_model()
    if qm is not None:
        rng = np.random.default_rng((seed if seed is not None else trial) + 7777)
        quals = qm.sample(rng, n)
    return reads, quals
