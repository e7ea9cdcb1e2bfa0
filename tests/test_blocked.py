"""Blocked (protograph, one-hot routing) BP decoder vs the generic gather decoder.

The blocked path must produce the same hard decisions, success flags and
iteration counts as ops/bp.py on both the small RS-LDPC family code and
the deployed n=18432 code (routing is bit-exact; posteriors differ only by
f32 reduction-order rounding, far from decision thresholds in practice).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dna_ldpc_tpu.models import BlockedCode, LdpcGraph, build_rs_ldpc
from dna_ldpc_tpu.models.blocked import dna_storage_blocked
from dna_ldpc_tpu.ops.bp import bp_decode, bp_decode_blocked


def _channel_llrs(n, batch, seed=0, coverage=3.7, eps=0.02):
    rng = np.random.default_rng(seed)
    mag = np.log((1 - eps) / eps)
    cov = rng.poisson(coverage, (batch, n))
    errs = rng.binomial(cov, eps)
    return ((cov - 2 * errs) * mag).astype(np.float32)


def test_detect_small_family_code():
    H = build_rs_ldpc(4, 8, 4)
    code = BlockedCode.detect(H)
    assert code is not None
    assert (code.q, code.G, code.J) == (16, 4, 8)
    # every block is a permutation
    assert (np.sort(code.pi, axis=-1) == np.arange(16)).all()


def test_detect_rejects_irregular():
    from dna_ldpc_tpu.utils.io_formats import SparseBinaryMatrix

    rows = np.array([0, 0, 1])
    cols = np.array([0, 1, 1])
    H = SparseBinaryMatrix.from_coo(2, 2, rows, cols)
    assert BlockedCode.detect(H) is None


def test_blocked_matches_gather_small():
    H = build_rs_ldpc(4, 8, 4)
    code = BlockedCode.detect(H)
    graph = LdpcGraph.from_sparse(H)
    llr = jnp.asarray(_channel_llrs(H.n_cols, 64, seed=3))
    a = bp_decode(graph, llr, max_iter=50)
    b = bp_decode_blocked(code, llr, max_iter=50)
    assert (np.asarray(a.bits) == np.asarray(b.bits)).all()
    assert (np.asarray(a.success) == np.asarray(b.success)).all()
    assert (np.asarray(a.iterations) == np.asarray(b.iterations)).all()
    assert (np.asarray(a.unsat) == np.asarray(b.unsat)).all()


def test_blocked_erasures_and_saturated():
    """Zero LLRs (erasures) and huge LLRs exercise the zero-factor and
    clip paths of the check update."""
    H = build_rs_ldpc(4, 8, 4)
    code = BlockedCode.detect(H)
    graph = LdpcGraph.from_sparse(H)
    llr = _channel_llrs(H.n_cols, 16, seed=5)
    llr[:, ::7] = 0.0
    llr[:, 3] = 1e30
    llr = jnp.asarray(llr)
    a = bp_decode(graph, llr, max_iter=30)
    b = bp_decode_blocked(code, llr, max_iter=30)
    assert (np.asarray(a.bits) == np.asarray(b.bits)).all()
    assert (np.asarray(a.success) == np.asarray(b.success)).all()


def test_deployed_blocked_structure():
    code = dna_storage_blocked()
    assert (code.q, code.G, code.J) == (256, 8, 72)
    assert code.n_checks == 2048 and code.n_vars == 18432
    # column mapping is a permutation
    assert len(np.unique(code.col_to_canonical)) == code.n_vars


@pytest.mark.slow
def test_blocked_matches_gather_deployed():
    from dna_ldpc_tpu.models.rs_ldpc import dna_storage_pchk

    code = dna_storage_blocked()
    graph = LdpcGraph.from_sparse(dna_storage_pchk())
    llr = jnp.asarray(_channel_llrs(18432, 4, seed=11))
    a = bp_decode(graph, llr, max_iter=30)
    b = bp_decode_blocked(code, llr, max_iter=30)
    assert (np.asarray(a.bits) == np.asarray(b.bits)).all()
    assert (np.asarray(a.success) == np.asarray(b.success)).all()
    assert (np.asarray(a.iterations) == np.asarray(b.iterations)).all()
