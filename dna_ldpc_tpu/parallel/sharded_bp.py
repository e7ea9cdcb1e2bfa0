"""Multi-device sharded BP: codewords x Tanner-graph over a (cw, graph) mesh.

The decomposition exploits a structural property of the RS-LDPC
construction (``RS LDPC encode/RS_LDPC/RS_LDPC.c:420-428``): the M = gamma*q
checks fall into gamma cosets of q checks, and every variable has exactly
one edge into each coset. Sharding checks by coset therefore gives each
graph-shard a perfectly balanced slice of edges, and the BP variable update
becomes

    posterior = channel_llr + psum_over_graph( local scatter of c2v ),

a single all-reduce per iteration — the device-mesh analogue of the
reference's commented-out ``MPI_Reduce`` error aggregation
(``DNA_main.cpp:1187-1193``), but inside the inner decoding loop. The
check update, the v2c refresh (posterior minus own c2v), and the local
syndrome are all shard-local; the early-stop consensus is one scalar psum.

The implementation is generic over any row partition of H (it only assumes
the check-side tables are sharded by rows), so irregular codes work too —
cosets just make the flagship perfectly balanced.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.ldpc_graph import LdpcGraph
from ..ops.bp import BpResult, _check_messages
from .mesh import CW_AXIS, GRAPH_AXIS


def _local_unsat(bits, check_vars, check_mask):
    g = jnp.take(bits, jnp.maximum(check_vars, 0).reshape(-1), axis=1)
    g = g.reshape(bits.shape[0], *check_vars.shape)
    g = jnp.where(check_mask[None], g, 0)
    parity = jnp.sum(g, axis=-1) % 2
    return jnp.sum(parity, axis=-1).astype(jnp.int32)


@functools.lru_cache(maxsize=16)
def make_sharded_decoder(graph: LdpcGraph, mesh: Mesh, max_iter: int = 200):
    """Build a jitted sharded decoder fn(llr [B, N]) -> BpResult.

    B must divide evenly over the ``cw`` axis and graph.n_checks over the
    ``graph`` axis.
    """
    M, N, dc = graph.n_checks, graph.n_vars, graph.dc_max

    check_vars_h = jnp.asarray(graph.check_vars)
    check_mask_h = jnp.asarray(graph.check_mask)

    in_specs = (
        P(CW_AXIS, None),        # llr
        P(GRAPH_AXIS, None),     # check_vars rows
        P(GRAPH_AXIS, None),     # check_mask rows
    )
    out_specs = (
        P(CW_AXIS, None),  # bits
        P(CW_AXIS),        # success
        P(CW_AXIS),        # iterations
        P(CW_AXIS),        # unsat
    )

    def shard_fn(llr, check_vars, check_mask):
        # llr: [Bs, N] (replicated over graph); check tables: [Ms, dc]
        Bs = llr.shape[0]
        dtype = llr.dtype
        clip_t = jnp.asarray(1.0, dtype) - jnp.finfo(dtype).eps
        edge_var = jnp.maximum(check_vars, 0).reshape(-1)  # [Ms*dc]

        bits0 = (llr < 0).astype(jnp.uint8)
        unsat0 = jax.lax.psum(
            _local_unsat(bits0.astype(jnp.int32), check_vars, check_mask), GRAPH_AXIS
        )
        done0 = unsat0 == 0
        v0 = jnp.take(llr, edge_var, axis=1)  # [Bs, Ms*dc]

        def cond(state):
            n, *_, done, _ = state
            return (n < max_iter) & ~jnp.all(done)

        def body(state):
            n, v2c, bits, iters, done, unsat = state
            Ms = check_vars.shape[0]
            c2v = _check_messages(v2c.reshape(Bs, Ms, dc), check_mask, clip_t)
            c2v_flat = jnp.where(check_mask.reshape(-1)[None], c2v.reshape(Bs, Ms * dc), 0)
            # local scatter of c2v sums into variable space, then all-reduce
            local_sum = jnp.zeros((Bs, N), dtype).at[:, edge_var].add(c2v_flat)
            total = jax.lax.psum(local_sum, GRAPH_AXIS)
            post = llr + total
            new_bits = (~(post > 0)).astype(jnp.uint8)
            # v2c refresh is shard-local: posterior minus own c2v message
            new_v2c = jnp.take(post, edge_var, axis=1) - c2v_flat

            new_unsat = jax.lax.psum(
                _local_unsat(new_bits.astype(jnp.int32), check_vars, check_mask),
                GRAPH_AXIS,
            )
            bits = jnp.where(done[:, None], bits, new_bits)
            unsat = jnp.where(done, unsat, new_unsat)
            iters = jnp.where(done, iters, n + 1)
            done = done | (new_unsat == 0)
            return (n + 1, new_v2c, bits, iters, done, unsat)

        state = (jnp.int32(0), v0, bits0, jnp.zeros(Bs, jnp.int32), done0, unsat0)
        _, _, bits, iters, done, unsat = jax.lax.while_loop(cond, body, state)
        return bits, done, iters, unsat

    mapped = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )

    @jax.jit
    def decode(llr):
        bits, success, iters, unsat = mapped(llr, check_vars_h, check_mask_h)
        return BpResult(bits=bits, success=success, iterations=iters, unsat=unsat)

    return decode


def sharded_decode(
    graph: LdpcGraph, mesh: Mesh, llrs: np.ndarray, max_iter: int = 200
) -> BpResult:
    """Host entry: place [B, N] LLRs onto the mesh and decode."""
    fn = make_sharded_decoder(graph, mesh, max_iter)
    sharding = NamedSharding(mesh, P(CW_AXIS, None))
    llr = jax.device_put(jnp.asarray(np.atleast_2d(llrs), jnp.float32), sharding)
    return fn(llr)


# ---------------------------------------------------------------------------
# Sharded BLOCKED decoder: one-hot routing over a (cw, graph) mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def make_sharded_blocked_decoder(code, mesh: Mesh, max_iter: int = 200):
    """Sharded variant of ops/bp.bp_decode_blocked: the G cosets (= the
    blocked code's check groups) shard over the ``graph`` axis, so every
    device runs its cosets' routing matmuls locally and the variable-side
    sum is ONE psum of a [J, q, Bs] partial per iteration — message
    traffic per step is n-proportional, not edge-proportional.

    Requires mesh graph-axis size to divide code.G (gamma=8 deployed).
    Routing runs in the ``"exact"`` mode's precision (f32 operands,
    ``Precision.HIGHEST``). For plain codeword data parallelism, which
    needs no cross-device graph traffic, see
    :func:`make_sharded_cw_decoder`.
    """
    G, J, q = code.G, code.J, code.q
    N = code.n_vars
    n_graph = mesh.shape[GRAPH_AXIS]
    if G % n_graph:
        raise ValueError(f"graph axis {n_graph} must divide G={G}")

    R_vc, A_sum = code.routing_tables()          # [G,J,q,q] / [J,q,G*q]
    A_sum4 = A_sum.reshape(J, q, G, q)           # expose the coset axis
    canon_idx = jnp.asarray(code.canonical_gather())
    ext_idx = jnp.asarray(code.external_gather())

    in_specs = (
        P(CW_AXIS, None),              # llr [B, N]
        P(GRAPH_AXIS),                 # R_vc cosets
        P(None, None, GRAPH_AXIS, None),  # A_sum4 cosets
    )
    out_specs = (P(CW_AXIS, None), P(CW_AXIS), P(CW_AXIS), P(CW_AXIS))
    prec = jax.lax.Precision.HIGHEST

    def shard_fn(llr, R_local, A_local4):
        Bs = llr.shape[0]
        Gs = R_local.shape[0]
        dtype = llr.dtype
        clip_t = jnp.asarray(1.0, dtype) - jnp.finfo(dtype).eps
        A_local = A_local4.reshape(J, q, Gs * q)

        llrT = llr[:, canon_idx].T.reshape(J, q, Bs)

        def route_to_checks(x):
            return jax.lax.dot_general(
                R_local, jnp.broadcast_to(x, (Gs, J, q, Bs)),
                (((3,), (2,)), ((0, 1), (0, 1))),
                precision=prec, preferred_element_type=jnp.float32,
            )

        def local_unsat(signs_pc):
            parity = jnp.sum(signs_pc, axis=1) % 2            # [Gs, q, Bs]
            return jnp.sum(parity, axis=(0, 1)).astype(jnp.int32)

        v2c0 = route_to_checks(llrT)
        bits0 = (llrT < 0).astype(jnp.uint8)
        unsat0 = jax.lax.psum(local_unsat((v2c0 < 0).astype(jnp.int32)), GRAPH_AXIS)
        done0 = unsat0 == 0

        def cond(state):
            n, *_, done, _ = state
            return (n < max_iter) & ~jnp.all(done)

        def body(state):
            n, v2c, bits, iters, done, unsat = state
            t = jnp.tanh(v2c * 0.5)
            is_zero = t == 0
            neg = t < 0
            logabs = jnp.log(jnp.where(is_zero, jnp.ones_like(t), jnp.abs(t)))
            sum_log = jnp.sum(logabs, axis=1, keepdims=True)
            n_zero = jnp.sum(is_zero, axis=1, keepdims=True)
            n_neg = jnp.sum(neg, axis=1, keepdims=True)
            mag = jnp.exp(sum_log - logabs)
            sign = 1.0 - 2.0 * ((n_neg - neg.astype(n_neg.dtype)) % 2).astype(dtype)
            te = jnp.where(
                (n_zero - is_zero.astype(n_zero.dtype)) > 0, jnp.zeros_like(t), sign * mag
            )
            te = jnp.clip(te, -clip_t, clip_t)
            c2v = jnp.log1p(te) - jnp.log1p(-te)   # [Gs, J, q, Bs]
            c2v = jax.lax.optimization_barrier(c2v)
            stacked = c2v.transpose(1, 0, 2, 3).reshape(J, Gs * q, Bs)
            partial = jax.lax.dot_general(
                A_local, stacked, (((2,), (1,)), ((0,), (0,))),
                precision=prec, preferred_element_type=jnp.float32,
            )
            post = llrT + jax.lax.psum(partial, GRAPH_AXIS)   # [J, q, Bs]
            post = jax.lax.optimization_barrier(post)
            post_pc = route_to_checks(post)
            new_v2c = post_pc - c2v
            new_bits = (~(post > 0)).astype(jnp.uint8)
            new_unsat = jax.lax.psum(
                local_unsat((~(post_pc > 0)).astype(jnp.int32)), GRAPH_AXIS
            )
            bits = jnp.where(done[None, None, :], bits, new_bits)
            unsat = jnp.where(done, unsat, new_unsat)
            iters = jnp.where(done, iters, n + 1)
            done = done | (new_unsat == 0)
            return (n + 1, new_v2c, bits, iters, done, unsat)

        state = (jnp.int32(0), v2c0, bits0, jnp.zeros(Bs, jnp.int32), done0, unsat0)
        _, _, bits, iters, done, unsat = jax.lax.while_loop(cond, body, state)
        bits_ext = bits.reshape(N, Bs).T[:, ext_idx]
        return bits_ext, done, iters, unsat

    mapped = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )

    # the routing operators (~150 MB each at the deployed shape) are
    # uploaded ONCE as sharded device arrays and passed as jit ARGUMENTS
    # — closed over as numpy they would be inlined into the HLO as
    # constants
    R_dev = jax.device_put(
        jnp.asarray(R_vc), NamedSharding(mesh, P(GRAPH_AXIS))
    )
    A_dev = jax.device_put(
        jnp.asarray(A_sum4), NamedSharding(mesh, P(None, None, GRAPH_AXIS, None))
    )

    @jax.jit
    def decode_impl(llr, R, A):
        bits, success, iters, unsat = mapped(llr, R, A)
        return BpResult(bits=bits, success=success, iterations=iters, unsat=unsat)

    def decode(llr):
        return decode_impl(llr, R_dev, A_dev)

    return decode


def sharded_blocked_decode(code, mesh: Mesh, llrs: np.ndarray, max_iter: int = 200) -> BpResult:
    """Host entry for the sharded blocked decoder."""
    fn = make_sharded_blocked_decoder(code, mesh, max_iter)
    sharding = NamedSharding(mesh, P(CW_AXIS, None))
    llr = jax.device_put(jnp.asarray(np.atleast_2d(llrs), jnp.float32), sharding)
    return fn(llr)


@functools.lru_cache(maxsize=16)
def make_sharded_cw_decoder(graph: LdpcGraph, mesh: Mesh, max_iter: int = 200, mode: str = "exact"):
    """Codeword-axis data parallelism: fn(llr [B, N]) -> BpResult, where
    every device runs the single-device decoder (``ops.bp.bp_decode``'s
    formulation ``mode``) on its shard of codewords, so no graph traffic
    crosses devices. B must divide evenly over the ``cw`` axis; a graph
    axis, if any, just replicates."""
    from ..ops.bp import _bp_blocked_jit, _bp_decode_jit, routing_operands

    if mode == "gather" or graph.blocked is None:
        step = _bp_decode_jit(graph, max_iter, None, True)
        operands = ()
    else:
        step = _bp_blocked_jit(graph.blocked, max_iter, True, mode)
        # routing operators replicated once per device, passed as
        # arguments (not baked into the HLO as constants)
        operands = tuple(
            jax.device_put(jnp.asarray(a), NamedSharding(mesh, P()))
            for a in routing_operands(graph.blocked, mode)
        )

    def shard_fn(llr, *ops):
        r = step(llr, *ops)
        return r.bits, r.success, r.iterations, r.unsat

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(CW_AXIS, None),) + (P(),) * len(operands),
        out_specs=(P(CW_AXIS, None), P(CW_AXIS), P(CW_AXIS), P(CW_AXIS)),
        check_vma=False,
    )

    @jax.jit
    def decode_impl(llr, *ops):
        bits, success, iters, unsat = mapped(llr, *ops)
        return BpResult(bits=bits, success=success, iterations=iters, unsat=unsat)

    def decode(llr):
        return decode_impl(llr, *operands)

    return decode
