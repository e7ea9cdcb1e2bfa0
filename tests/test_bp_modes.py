"""Blocked BP throughput modes ("fast" bf16 routing, "bf16" message
storage) must reach the same decoded codewords as the exact mode on
trial-like channel workloads (FER parity acceptance, SURVEY.md §7.2)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dna_ldpc_tpu.models import BlockedCode, build_rs_ldpc
from dna_ldpc_tpu.models.mod2 import random_codewords
from dna_ldpc_tpu.ops.bp import bp_decode_blocked


@pytest.fixture(scope="module")
def small():
    H = build_rs_ldpc(4, 12, 4)  # 64 x 192, dv=4 dc=12
    code = BlockedCode.detect(H)
    assert code is not None
    rng = np.random.default_rng(0)
    cw = random_codewords(H.to_dense(), 32, rng)
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(5.0, cw.shape)
    errs = rng.binomial(cov, 0.02)
    votes = cov - 2 * errs
    llr = (votes * mag * np.where(cw == 0, 1.0, -1.0)).astype(np.float32)
    return code, cw, jnp.asarray(llr)


@pytest.mark.parametrize("mode", ["fast", "bf16"])
def test_modes_reach_exact_outcomes(small, mode):
    code, cw, llr = small
    exact = bp_decode_blocked(code, llr, max_iter=50, mode="exact")
    other = bp_decode_blocked(code, llr, max_iter=50, mode=mode)
    ok_e = np.asarray(exact.success)
    ok_o = np.asarray(other.success)
    assert (ok_e == ok_o).all()
    # successful decodes recover the transmitted codewords in all modes
    be = np.asarray(exact.bits)[ok_e]
    bo = np.asarray(other.bits)[ok_o]
    assert (be == cw[ok_e]).all()
    assert (bo == cw[ok_o]).all()


def test_bad_mode_rejected(small):
    code, _, llr = small
    with pytest.raises(ValueError):
        bp_decode_blocked(code, llr, mode="fp8")


@pytest.mark.parametrize(
    "platform, expected", [("cpu", "exact"), ("gpu", "gather"), ("rocm", None)]
)
def test_auto_bp_mode_by_platform(platform, expected):
    """The trial's BP formulation is chosen by JAX platform; a platform
    without a measured choice raises instead of defaulting."""
    from dna_ldpc_tpu.pipeline.decode import BP_MODE_BY_PLATFORM, _auto_bp_mode

    if expected is None:
        with pytest.raises(ValueError):
            _auto_bp_mode(platform)
    else:
        assert _auto_bp_mode(platform) == expected == BP_MODE_BY_PLATFORM[platform]


def test_gather_mode_matches_exact(small):
    """The generic gather decoder and the blocked exact decoder reach the
    same decisions on the same graph."""
    import dataclasses

    from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph
    from dna_ldpc_tpu.ops.bp import bp_decode

    code, cw, llr = small
    H = build_rs_ldpc(4, 12, 4)
    g = dataclasses.replace(LdpcGraph.from_sparse(H, detect_blocked=False), blocked=code)
    gather = bp_decode(g, llr, max_iter=50, mode="gather")
    exact = bp_decode(g, llr, max_iter=50, mode="exact")
    np.testing.assert_array_equal(np.asarray(gather.success), np.asarray(exact.success))
    ok = np.asarray(gather.success)
    assert ok.any()
    np.testing.assert_array_equal(np.asarray(gather.bits)[ok], np.asarray(exact.bits)[ok])
