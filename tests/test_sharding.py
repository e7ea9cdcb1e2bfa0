"""Multi-device tests on the 8-virtual-CPU-device mesh: the sharded
(cw x graph) BP decoder must agree bit-for-bit with the single-device
decoder, and the mesh helpers must produce valid layouts."""

import jax
import numpy as np
import pytest

from dna_ldpc_tpu.models.ldpc_graph import LdpcGraph
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc
from dna_ldpc_tpu.ops.bp import decode_llrs
from dna_ldpc_tpu.parallel.mesh import build_mesh
from dna_ldpc_tpu.parallel.sharded_bp import sharded_decode


@pytest.fixture(scope="module")
def setup():
    H = build_rs_ldpc(4, 8, 4)  # 64 x 128, gamma=4 cosets
    return H, LdpcGraph.from_sparse(H)


def _llrs(rng, B, n):
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(3.7, (B, n))
    errs = rng.binomial(cov, 0.02)
    return ((cov - 2 * errs) * mag).astype(np.float32)


def test_mesh_shapes():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    mesh = build_mesh()
    assert mesh.devices.shape == (1, 8)
    mesh2 = build_mesh(max_graph=4)
    assert mesh2.devices.shape == (2, 4)
    mesh3 = build_mesh(n_graph=2)
    assert mesh3.devices.shape == (4, 2)


def test_sharded_matches_single_device(setup):
    H, g = setup
    rng = np.random.default_rng(0)
    llr = _llrs(rng, 8, 128)
    mesh = build_mesh(max_graph=4)  # (2 cw, 4 graph): one coset per shard
    r_sh = sharded_decode(g, mesh, llr, max_iter=30)
    r_ref = decode_llrs(g, llr, max_iter=30)
    assert np.array_equal(np.asarray(r_sh.bits), np.asarray(r_ref.bits))
    assert np.array_equal(np.asarray(r_sh.success), np.asarray(r_ref.success))
    assert np.array_equal(np.asarray(r_sh.unsat), np.asarray(r_ref.unsat))


def test_sharded_pure_dp(setup):
    """graph axis of size 1 (pure codeword data parallelism)."""
    H, g = setup
    rng = np.random.default_rng(1)
    llr = _llrs(rng, 16, 128)
    mesh = build_mesh(n_graph=1)
    r_sh = sharded_decode(g, mesh, llr, max_iter=30)
    r_ref = decode_llrs(g, llr, max_iter=30)
    assert np.array_equal(np.asarray(r_sh.bits), np.asarray(r_ref.bits))


def test_sharded_deployed_graph_small_batch():
    """The real 2048x18432 graph sharded over (2, 4) — tiny batch."""
    from dna_ldpc_tpu.models.rs_ldpc import dna_storage_pchk

    g = LdpcGraph.from_sparse(dna_storage_pchk())
    rng = np.random.default_rng(2)
    llr = _llrs(rng, 2, 18432)
    mesh = build_mesh(max_graph=4)
    r_sh = sharded_decode(g, mesh, llr, max_iter=10)
    r_ref = decode_llrs(g, llr, max_iter=10)
    assert np.array_equal(np.asarray(r_sh.bits), np.asarray(r_ref.bits))
    assert np.array_equal(np.asarray(r_sh.iterations), np.asarray(r_ref.iterations))


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_blocked_matches_single_device():
    import jax
    import jax.numpy as jnp

    from dna_ldpc_tpu.models import BlockedCode, build_rs_ldpc
    from dna_ldpc_tpu.ops.bp import bp_decode_blocked
    from dna_ldpc_tpu.parallel.mesh import build_mesh
    from dna_ldpc_tpu.parallel.sharded_bp import sharded_blocked_decode

    H = build_rs_ldpc(4, 8, 4)
    code = BlockedCode.detect(H)
    mesh = build_mesh(devices=jax.devices()[:8], max_graph=4)
    rng = np.random.default_rng(5)
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(3.7, (8, H.n_cols))
    errs = rng.binomial(cov, 0.02)
    llr = ((cov - 2 * errs) * mag).astype(np.float32)

    sharded = sharded_blocked_decode(code, mesh, llr, max_iter=30)
    single = bp_decode_blocked(code, jnp.asarray(llr), max_iter=30)
    assert (np.asarray(sharded.bits) == np.asarray(single.bits)).all()
    assert (np.asarray(sharded.success) == np.asarray(single.success)).all()
    assert (np.asarray(sharded.iterations) == np.asarray(single.iterations)).all()


@pytest.mark.parametrize("mode", ["gather", "exact"])
def test_sharded_cw_decoder_matches_single_device(mode):
    """Codeword-axis data parallelism over 8 virtual devices: each shard
    runs the single-device decoder, so results equal one device's."""
    from dna_ldpc_tpu.models.blocked import BlockedCode
    from dna_ldpc_tpu.ops.bp import bp_decode
    from dna_ldpc_tpu.parallel.mesh import CW_AXIS
    from dna_ldpc_tpu.parallel.sharded_bp import make_sharded_cw_decoder
    import dataclasses
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    H = build_rs_ldpc(4, 8, 4)
    g = dataclasses.replace(LdpcGraph.from_sparse(H), blocked=BlockedCode.detect(H))
    mesh = build_mesh(devices=jax.devices()[:8], n_graph=1)
    assert mesh.devices.shape == (8, 1)
    llr = _llrs(np.random.default_rng(11), 16, H.n_cols)
    decode = make_sharded_cw_decoder(g, mesh, max_iter=30, mode=mode)
    r = decode(jax.device_put(jnp.asarray(llr), NamedSharding(mesh, P(CW_AXIS, None))))
    ref = bp_decode(g, jnp.asarray(llr), max_iter=30, mode=mode)
    for field in ("bits", "success", "iterations", "unsat"):
        np.testing.assert_array_equal(np.asarray(getattr(r, field)), np.asarray(getattr(ref, field)))
    assert np.asarray(r.success).any()

