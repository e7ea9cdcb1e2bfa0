"""Ten-trial regression at the calibrated channel (VERDICT r3 item 4).

The golden result files (`o_72000_7_<0..9>_0.020000_result.txt`) show all
10 reference trials decode, with anneal iterations {7x0, 1x1, 2x8}. The
real read blobs are missing upstream, so exact replay is impossible; this
regression simulates 10 reference-SHAPED trials instead — per-trial read
counts and the empirical quality-character distribution come from the
shipped Q files — and asserts every trial decodes with a reference-like
(near-zero) anneal-iteration profile.

The full 10-trial run needs the GPU pipeline (the CPU path would take
hours) and is marked slow; the calibration plumbing itself is covered by
the fast tests below.
"""

import os

import numpy as np
import pytest

from conftest import requires_reference

REFERENCE = "/root/reference"


@requires_reference
def test_quality_model_matches_shipped_distribution():
    from dna_ldpc_tpu.pipeline.simulate import (
        QualityModel,
        reference_quality_model,
        reference_read_count,
    )

    qm = reference_quality_model()
    assert qm is not None
    probs = dict(zip(qm.chars, qm.probs))
    assert abs(sum(qm.probs) - 1.0) < 1e-9
    # the shipped distribution's headline facts (measured): 'C' ~ 88%,
    # <53 (bit-271 exclusion threshold) ~ 1.3%, > 63 ~ 95.7%
    assert 0.85 < probs[ord("C")] < 0.91
    low = sum(p for c, p in probs.items() if c < 53)
    high = sum(p for c, p in probs.items() if c > 63)
    assert 0.008 < low < 0.02
    assert 0.94 < high < 0.97

    counts = [reference_read_count(t) for t in range(10)]
    assert all(c is not None for c in counts)
    assert min(counts) >= 67800 and max(counts) <= 68000

    rng = np.random.default_rng(0)
    sample = qm.sample(rng, 20000)
    frac_c = sum(1 for q in sample if q == "C") / len(sample)
    assert abs(frac_c - probs[ord("C")]) < 0.02


@requires_reference
def test_simulate_trial_uses_calibration():
    from dna_ldpc_tpu.pipeline.simulate import (
        load_oligos,
        reference_read_count,
        simulate_trial,
    )

    oligos = load_oligos(os.path.join(REFERENCE, "original files", "final_DNA.txt"))
    reads, quals = simulate_trial(oligos, trial=3)
    assert len(reads) == len(quals) == reference_read_count(3)
    assert sum(1 for q in quals if q == "C") / len(quals) > 0.8


TEN_TRIAL_SCRIPT = r"""
import json, os
from dna_ldpc_tpu.cli import _load_codewords
from dna_ldpc_tpu.pipeline.decode import TrialConfig, decode_trial
from dna_ldpc_tpu.pipeline.simulate import load_oligos, simulate_trial

REFERENCE = "/root/reference"
oligos = load_oligos(os.path.join(REFERENCE, "original files", "final_DNA.txt"))
codewords = _load_codewords(os.path.join(REFERENCE, "ex_decoder"))
out = []
for t in range(10):
    reads, quals = simulate_trial(oligos, trial=t)
    r = decode_trial(reads, quals, codewords, TrialConfig())
    out.append({"trial": t, "ok": bool(r.success), "anneal": int(r.n_anneal_iters),
                "seconds": round(r.total_time, 1)})
    print("TRIAL_DONE " + json.dumps(out[-1]), flush=True)
print("TEN_TRIALS " + json.dumps(out))

# stressed-channel point: reduced coverage pushes the code to its
# erasure threshold so the second decoding demonstrably fires, mirroring
# the golden profile's recovered-failure trials
# (o_72000_7_{1,5,8}_0.020000_result.txt: 1, 8, 8 anneal rounds)
from dna_ldpc_tpu.pipeline.simulate import ChannelModel, simulate_reads
reads, quals = simulate_reads(oligos, 65500, ChannelModel(), seed=123)
r = decode_trial(reads, quals, codewords, TrialConfig())
print("STRESS_TRIAL " + json.dumps({
    "ok": bool(r.success), "fail_first": [int(i) for i in r.fail_first],
    "anneal": int(r.n_anneal_iters)}))
"""


@pytest.mark.slow
@requires_reference
@pytest.mark.skipif(
    os.environ.get("DNA_LDPC_RUN_TEN_TRIALS") != "1",
    reason="10 full trials need the GPU pipeline; set DNA_LDPC_RUN_TEN_TRIALS=1",
)
def test_ten_trials_decode():
    """Spawned WITHOUT the conftest's CPU pinning so the pipeline runs on
    the real chip (the CPU path would take hours)."""
    import json
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS",)}
    proc = subprocess.run(
        [sys.executable, "-c", TEN_TRIAL_SCRIPT],
        capture_output=True, text=True, timeout=3600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    results = None
    stress = None
    for line in proc.stdout.splitlines():
        if line.startswith("TEN_TRIALS "):
            results = json.loads(line[len("TEN_TRIALS "):])
        if line.startswith("STRESS_TRIAL "):
            stress = json.loads(line[len("STRESS_TRIAL "):])
    assert results is not None, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert all(r["ok"] for r in results), results
    anneal = [r["anneal"] for r in results]
    # reference golden profile: {7x0, 1x1, 2x8} — near-zero for most
    # trials; the simulated channel is cleaner than the real reads, so
    # require a profile at least as good
    assert sum(1 for a in anneal if a == 0) >= 7
    assert max(anneal) <= 8
    # stressed point: the second decoding must FIRE (>=1 first-decode
    # failure) and recover it through the epsilon-anneal loop, like the
    # golden trials 1/5/8 (decoder.py:594-664 semantics end to end)
    assert stress is not None, proc.stdout[-2000:]
    assert stress["ok"] and len(stress["fail_first"]) >= 1 and stress["anneal"] >= 1, stress
