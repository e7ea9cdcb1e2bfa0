"""BP state tracing (Save_State analog)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dna_ldpc_tpu.models import BlockedCode, build_rs_ldpc
from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph
from dna_ldpc_tpu.models.mod2 import random_codewords
from dna_ldpc_tpu.ops.bp import decode_llrs
from dna_ldpc_tpu.ops.trace import bp_trace, format_word_state


@pytest.fixture(scope="module")
def small():
    H = build_rs_ldpc(4, 12, 4)  # 64 x 192, dv=4 dc=12, q=16
    code = BlockedCode.detect(H)
    assert code is not None
    graph = LdpcGraph.from_sparse(H)
    rng = np.random.default_rng(0)
    cw = random_codewords(H.to_dense(), 24, rng)
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(5.0, cw.shape)
    errs = rng.binomial(cov, 0.02)
    votes = cov - 2 * errs
    llr = (votes * mag * np.where(cw == 0, 1.0, -1.0)).astype(np.float32)
    return H, code, graph, cw, jnp.asarray(llr)


def test_trace_matches_decoder(small):
    H, code, graph, cw, llr = small
    tr = bp_trace(graph, llr, iters=12)
    assert tr.bits.shape == (12, 24, 192)
    r = decode_llrs(graph, np.asarray(llr), max_iter=12)
    # converged words: trace at the latched iteration equals the decode
    it = np.asarray(r.iterations)
    ok = np.asarray(r.success) & (it > 0)
    for b in np.nonzero(ok)[0]:
        assert np.array_equal(
            np.asarray(tr.bits)[it[b] - 1, b], np.asarray(r.bits)[b]
        )
        assert int(np.asarray(tr.unsat)[it[b] - 1, b]) == 0
    # syndrome counts consistent with per-check flags
    assert np.array_equal(
        np.asarray(tr.check_unsat).sum(-1).astype(np.int32), np.asarray(tr.unsat)
    )


def test_format_word_state(small):
    H, code, graph, cw, llr = small
    tr = bp_trace(graph, llr, iters=6)
    rep = format_word_state(tr, b=0, true_word=cw[0])
    assert "unsat_checks" in rep and "variables" in rep
    rep2 = format_word_state(tr, b=1)
    assert "most-oscillating" in rep2
