"""Top-of-stack tests: decode_trial end-to-end, CLI, report golden-file
parity, checkpoint save/resume (reference surface: ex_decoder/decoder.py
trial loop + result files o_72000_7_*_result.txt)."""

import os

import numpy as np
import pytest

from conftest import REFERENCE, requires_reference

from dna_ldpc_tpu.models import LdpcGraph
from dna_ldpc_tpu.models.codebook import N_STRANDS
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc
from dna_ldpc_tpu.pipeline.decode import TrialConfig, anneal_decode, decode_trial
from dna_ldpc_tpu.pipeline.report import format_result, parse_result, write_result
from dna_ldpc_tpu.pipeline.simulate import strand_index_dna, synthetic_pool
from dna_ldpc_tpu.utils import dna

GOLDEN_DIR = os.path.join(REFERENCE, "ex_decoder")


# ---------------------------------------------------------------------------
# fabricated valid trials (RS-encoded indices + payload from codeword bits)
# ---------------------------------------------------------------------------


def make_trial_reads(codewords: np.ndarray, coverage: int = 2,
                     deletion_strands=(), seed: int = 0):
    """Clean reads covering every strand ``coverage`` times; strands in
    ``deletion_strands`` additionally get one read with a single deleted
    base (forcing the mixed-length edit-filter + MSA path)."""
    idx_dna = strand_index_dna()
    payload_bits = codewords.T.astype(np.uint8)               # [S, 272]
    payload = dna.bits_to_dna(payload_bits)                   # [S, 136]
    oligo = np.concatenate([idx_dna, payload], axis=1)        # [S, 152]
    reads, quals = [], []
    rng = np.random.default_rng(seed)
    for s in range(oligo.shape[0]):
        r = oligo[s].tobytes().decode("ascii")
        for _ in range(coverage):
            reads.append(r)
            quals.append(chr(70))
    for s in deletion_strands:
        p = int(rng.integers(16, 150))  # delete inside the payload
        r = oligo[s].tobytes().decode("ascii")
        reads.append(r[:p] + r[p + 1:])
        quals.append(chr(70))
    return reads, quals


@pytest.fixture(scope="module")
def zero_codewords():
    return np.zeros((272, N_STRANDS), np.uint8)


def test_decode_trial_end_to_end_clean(zero_codewords):
    """Full-scale decode_trial on a fabricated clean trial: every strand
    covered, a handful of strands carry a deletion read so the
    edit-filter + cross-cluster batched MSA path runs. All 272 codewords
    must decode on the first pass (decoder.py:553-581 semantics)."""
    del_strands = list(range(0, 3000, 100))  # 30 mixed-length clusters
    reads, quals = make_trial_reads(
        zero_codewords, coverage=2, deletion_strands=del_strands
    )
    result = decode_trial(reads, quals, zero_codewords, TrialConfig(epsil=0.02))
    assert result.success
    assert result.fail_first == [] and result.fail_final == []
    assert result.n_anneal_iters == 0
    assert (result.decoded_bits == zero_codewords).all()
    assert result.n_reads_kept == len(reads)
    for key in ("rs_decode", "llr", "first_decode", "second_decode"):
        assert key in result.phase_times


def test_cli_simulate_smoke(tmp_path, zero_codewords):
    """CLI simulate end-to-end on a fabricated oligo pool (the o_/x_
    report file must appear and parse; reference README 'Codes')."""
    from dna_ldpc_tpu.cli import main

    idx_dna = strand_index_dna()
    payload = dna.bits_to_dna(zero_codewords.T.astype(np.uint8))
    oligos = np.concatenate([idx_dna, payload], axis=1)
    oligo_path = tmp_path / "final_DNA.txt"
    with open(oligo_path, "w") as f:
        for s in range(oligos.shape[0]):
            f.write(oligos[s].tobytes().decode("ascii") + "\n")
    cw_dir = tmp_path / "cw"
    cw_dir.mkdir()
    row = " ".join(["0"] * N_STRANDS) + "\n"
    for i in range(1, 273):
        with open(cw_dir / f"codeword_n18432_m1860_{i}.txt", "w") as f:
            f.write(row)

    rc = main([
        "simulate", "--oligos", str(oligo_path), "--codeword-dir", str(cw_dir),
        "--out-dir", str(tmp_path), "--rs", "90000", "--epsil", "0.02",
        "--start", "0", "--end", "1", "--sub-rate", "0.002",
        "--del-rate", "1e-5", "--ins-rate", "0.0", "--seed", "7",
    ])
    assert rc == 0
    out = tmp_path / "o_90000_0_0.020000_result.txt"
    assert out.exists()
    parsed = parse_result(out.read_text())
    assert parsed["success"] and parsed["first_ok"] == 272
    assert parsed["fail_first"] == [] and parsed["fail_final"] == []


def test_synthetic_pool_is_valid():
    """The shared seeded pool: every oracle codeword satisfies H, and
    every strand's RS index survives rs_filter_reads back to its rank
    with the 136-nt payload intact."""
    from dna_ldpc_tpu.models.rs_ldpc import dna_storage_pchk
    from dna_ldpc_tpu.pipeline.llr import rs_filter_reads

    cw, oligos = synthetic_pool(seed=3)
    assert cw.shape == (272, N_STRANDS) and cw.dtype == np.uint8
    H = dna_storage_pchk()
    assert all(int(H.mulvec(c).sum()) == 0 for c in cw)
    assert len(oligos) == N_STRANDS and {len(o) for o in oligos} == {152}
    cw2, _ = synthetic_pool(seed=3)
    np.testing.assert_array_equal(cw, cw2)
    filt = rs_filter_reads(oligos, [chr(70)] * len(oligos))
    assert len(filt.payloads) == N_STRANDS
    order = np.argsort(filt.strands, kind="stable")
    np.testing.assert_array_equal(np.asarray(filt.strands)[order], np.arange(N_STRANDS))
    for k in (0, 4097, N_STRANDS - 1):
        assert filt.payloads[order[k]] == oligos[k][16:]


# ---------------------------------------------------------------------------
# report format <-> golden files
# ---------------------------------------------------------------------------


@requires_reference
def test_parse_golden_result_files():
    """parse_result understands every shipped golden file and extracts the
    documented outcomes (BASELINE.md first-decoding table)."""
    expect_first = {1: (270, [32, 270]), 5: (271, [272]), 8: (271, [32])}
    for t in range(10):
        path = os.path.join(GOLDEN_DIR, f"o_72000_7_{t}_0.020000_result.txt")
        parsed = parse_result(open(path).read())
        assert parsed["success"]
        assert parsed["second_ok"] == 272 and parsed["fail_final"] == []
        first_ok, fails = expect_first.get(t, (272, []))
        assert parsed["first_ok"] == first_ok
        assert parsed["fail_first"] == fails


@requires_reference
def test_format_result_field_parity_with_golden(tmp_path):
    """format_result -> parse_result reproduces the golden file's parsed
    fields when fed the same outcome (trial 1: 270/272 first, 1 anneal
    iteration, failures 32 and 270 recovered)."""
    golden = parse_result(
        open(os.path.join(GOLDEN_DIR, "o_72000_7_1_0.020000_result.txt")).read()
    )
    from dna_ldpc_tpu.pipeline.decode import TrialResult

    result = TrialResult(
        success=True, fail_first=[32, 270], fail_final=[],
        n_anneal_iters=1, n_erasure_strands=0,
        decoded_bits=np.zeros((272, N_STRANDS), np.uint8),
        total_time=12.34,
    )
    path = write_result(result, 72000, 1, 0.02, str(tmp_path))
    assert os.path.basename(path) == "o_72000_1_0.020000_result.txt"
    ours = parse_result(open(path).read())
    for key in ("success", "first_ok", "second_ok", "anneal_iters",
                "fail_first", "fail_final"):
        assert ours[key] == golden[key], key
    assert ours["total_time"] == pytest.approx(12.34)


# ---------------------------------------------------------------------------
# checkpoint save / resume
# ---------------------------------------------------------------------------


def _tiny_graph():
    return LdpcGraph.from_sparse(build_rs_ldpc(4, 8, 4))  # 64 x 128


def _failing_soft():
    mag = np.log(0.98 / 0.02)
    rng = np.random.default_rng(3)
    soft = np.full((2, 128), mag, np.float32)
    soft[1] = 0.0
    keep = rng.permutation(128)[:40]
    soft[1, keep] = mag * np.where(rng.random(40) < 0.33, -3.0, 1.0)
    return soft


def test_checkpoint_roundtrip(tmp_path):
    from dna_ldpc_tpu.pipeline.checkpoint import TrialCheckpoint

    path = str(tmp_path / "ck.npz")
    ck = TrialCheckpoint(
        epsil=0.02,
        llr_table=np.arange(12, dtype=np.float64).reshape(3, 4),
        decoded_bits=np.ones((2, 4), np.uint8),
        fail_first=np.array([3, 7]),
        fail_current=np.array([7]),
        anneal_iters=4,
        n_reads_kept=99,
    )
    ck.save(path)
    back = TrialCheckpoint.load(path)
    assert back.epsil == 0.02 and back.anneal_iters == 4 and back.n_reads_kept == 99
    np.testing.assert_array_equal(back.llr_table, ck.llr_table)
    np.testing.assert_array_equal(back.decoded_bits, ck.decoded_bits)
    np.testing.assert_array_equal(back.fail_first, [3, 7])
    np.testing.assert_array_equal(back.fail_current, [7])
    # empty failure sets survive the roundtrip distinctly from "absent"
    ck2 = TrialCheckpoint(
        epsil=0.02, llr_table=ck.llr_table,
        decoded_bits=ck.decoded_bits,
        fail_first=np.zeros(0, np.int64), fail_current=np.zeros(0, np.int64),
    )
    ck2.save(path)
    back2 = TrialCheckpoint.load(path)
    assert back2.fail_first is not None and back2.fail_first.size == 0
    assert back2.fail_current is not None and back2.fail_current.size == 0


def test_anneal_resume_equivalence():
    """Interrupting the annealing loop after round k and resuming from the
    checkpointed (dec, fail, iters) state must yield the same final
    decision bits, failure set, and iteration count as an uninterrupted
    run (decoder.py:594-664 epsilon schedule)."""
    g = _tiny_graph()
    soft = _failing_soft()
    cws = np.zeros((2, 128), np.uint8)
    cfg = TrialConfig()

    states = []
    dec_a, ff_a, fail_a, iters_a = anneal_decode(
        g, soft, cws, cfg,
        save_cb=lambda d, ff, fc, it: states.append(
            (np.array(d), list(ff), list(fc), it)
        ),
    )
    assert iters_a >= 1 and len(states) == iters_a + 1

    for k in (0, len(states) // 2):  # resume right after first decode + mid-anneal
        dec_b, ff_b, fail_b, iters_b = anneal_decode(
            g, soft, cws, cfg, resume=states[k]
        )
        assert iters_b == iters_a
        assert ff_b == ff_a and fail_b == fail_a
        np.testing.assert_array_equal(dec_b, dec_a)


def test_decode_trial_checkpoint_resume(tmp_path, zero_codewords):
    """decode_trial writes a checkpoint after ingest and resumes from it:
    the second invocation must skip RS/LLR (phase times 0) and reproduce
    the same decode."""
    reads, quals = make_trial_reads(zero_codewords, coverage=2)
    path = str(tmp_path / "trial.npz")
    r1 = decode_trial(reads, quals, zero_codewords, TrialConfig(epsil=0.02),
                      checkpoint_path=path)
    assert r1.success and os.path.exists(path)
    r2 = decode_trial(reads, quals, zero_codewords, TrialConfig(epsil=0.02),
                      checkpoint_path=path)
    assert r2.success
    assert r2.phase_times["rs_decode"] == 0.0 and r2.phase_times["llr"] == 0.0
    # decoder progress was checkpointed too: the first decode is skipped
    assert r2.phase_times["first_decode"] == 0.0
    np.testing.assert_array_equal(r2.decoded_bits, r1.decoded_bits)
    assert r2.n_reads_kept == r1.n_reads_kept
    # an epsilon mismatch invalidates the checkpoint (full recompute)
    r3 = decode_trial(reads, quals, zero_codewords, TrialConfig(epsil=0.03),
                      checkpoint_path=path)
    assert r3.phase_times["rs_decode"] > 0.0
