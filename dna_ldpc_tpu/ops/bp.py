"""Batched flooding sum-product LDPC belief propagation (XLA).

Accelerator-batched redesign of the reference decoder
(``LDPC_dec/ldpc/dec.cpp:583-694``): instead of one process per codeword
walking linked edge lists in the probability-ratio domain, all codewords
decode together as ``[batch, n_edges]`` message arrays in the LLR domain,
with one gather per message direction per iteration (tables from
``models.ldpc_graph``) and a per-codeword syndrome early stop
(``check()``, ``check.cpp:28-47``) latching results independently.

Decision semantics match the reference exactly:

- initial hard decision: bit = (channel LLR < 0), i.e. ``lratio < 1``
  (``Init_Belief_Propagation``, dec.cpp:608-629);
- per-iteration decision: bit = (posterior LLR <= 0), i.e. ``pr <= 1``,
  with non-finite posteriors decided as 1 (``pr = NaN -> 1``,
  dec.cpp:676-686);
- syndrome is evaluated on the current decision *before* each iteration;
  the loop stops at iteration n if the syndrome is zero or n == max_iter
  (``Run_Belief_Propagation_Decoder``, dec.cpp:583-605), so a decode can
  succeed at n=0 without any message passing.

The check update is the probability-domain exclusive product
``dl *= 1 - 2/(1 + pr)`` of the reference expressed in its mathematically
identical tanh form: 1 - 2/(1+e^L) = tanh(L/2), and
(1+t)/(1-t) = exp(2 atanh t). Exclusive products use forward/backward
cumulative products exactly like the reference's two sweeps, which keeps
zero messages (erasures) exact instead of dividing by zero.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.ldpc_graph import LdpcGraph


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BpResult:
    bits: jax.Array        # [B, N] uint8 hard decisions (latched at stop)
    success: jax.Array     # [B] bool: syndrome reached zero
    iterations: jax.Array  # [B] int32: reference iteration count semantics
    unsat: jax.Array       # [B] int32: unsatisfied checks at stop


def _exclusive_prod(t: jax.Array, axis: int = -1) -> jax.Array:
    """Per-row exclusive product along ``axis``.

    Mathematically equal to the reference's forward/backward sweeps
    (dec.cpp:646-662) but computed as whole-row reductions (sign parity +
    log-magnitude sums + zero counting) instead of sequential cumulative
    products — reductions fuse into one pass and keep the HLO tiny, where
    a 72-step cumprod scan made XLA compile times explode. Zero
    factors (erasure messages) stay exact: an excluded product is zero iff
    it contains a zero factor."""
    dtype = t.dtype
    is_zero = t == 0
    neg = t < 0
    logabs = jnp.log(jnp.where(is_zero, jnp.ones_like(t), jnp.abs(t)))
    sum_log = jnp.sum(logabs, axis=axis, keepdims=True)
    n_zero = jnp.sum(is_zero, axis=axis, keepdims=True)
    n_neg = jnp.sum(neg, axis=axis, keepdims=True)
    excl_zero = n_zero - is_zero.astype(n_zero.dtype)
    excl_neg = n_neg - neg.astype(n_neg.dtype)
    mag = jnp.exp(sum_log - logabs)
    sign = jnp.asarray(1.0, dtype) - 2.0 * (excl_neg % 2).astype(dtype)
    return jnp.where(excl_zero > 0, jnp.zeros_like(t), sign * mag)


def _check_messages(v2c: jax.Array, check_mask: jax.Array, clip: float) -> jax.Array:
    """Check-node update in tanh domain. v2c: [B, M, dc] LLR messages
    (padded slots arbitrary); returns c2v [B, M, dc]."""
    t = jnp.tanh(v2c * 0.5)
    t = jnp.where(check_mask[None], t, jnp.ones_like(t))
    te = _exclusive_prod(t)
    te = jnp.clip(te, -clip, clip)
    # 2*atanh(te), written as log1p for accuracy near |te| ~ 1
    return jnp.log1p(te) - jnp.log1p(-te)


def _syndrome_unsat(bits: jax.Array, check_vars: jax.Array, check_mask: jax.Array) -> jax.Array:
    """Number of unsatisfied checks per batch element. bits: [B, N] int32."""
    gathered = jnp.take(bits, jnp.maximum(check_vars, 0).reshape(-1), axis=1)
    gathered = gathered.reshape(bits.shape[0], *check_vars.shape)
    gathered = jnp.where(check_mask[None], gathered, 0)
    parity = jnp.sum(gathered, axis=-1) % 2  # [B, M]
    return jnp.sum(parity, axis=-1).astype(jnp.int32)


def bp_decode(
    graph: LdpcGraph,
    llr: jax.Array,
    max_iter: int = 200,
    clip: Optional[float] = None,
    early_stop: bool = True,
    mode: Optional[str] = None,
) -> BpResult:
    """Decode a batch of LLR vectors. llr: [B, N], sign convention
    LLR >= 0 <=> bit 0 (log p0/p1, matching DNA_main.cpp:1340-1345).

    ``early_stop=False`` runs all max_iter iterations regardless of
    convergence (per-codeword results still latch at first zero syndrome);
    used for fixed-work benchmarking.

    ``mode`` picks the formulation (same semantics): ``"gather"`` is the
    generic edge-gather decoder below; codes with permutation-block
    (protograph) structure can instead take the one-hot routing decoder
    (:func:`bp_decode_blocked`) in its ``"exact"``/``"fast"``/``"bf16"``
    variants. None = ``"exact"`` for blocked codes. Graphs without
    blocked structure, and an explicit ``clip``, always take the gather
    path."""
    if mode == "gather" or graph.blocked is None or clip is not None:
        return _bp_decode_jit(graph, max_iter, clip, early_stop)(llr)
    return bp_decode_blocked(graph.blocked, llr, max_iter, early_stop, mode=mode)


@functools.lru_cache(maxsize=32)
def _bp_decode_jit(graph: LdpcGraph, max_iter: int, clip: Optional[float], early_stop: bool = True):
    tables = graph.device_tables()
    check_vars = tables["check_vars"]
    check_mask = tables["check_mask"]
    var_edge_ids = tables["var_edge_ids"].reshape(-1)
    edge_perm = tables["edge_perm"]
    M, N = graph.n_checks, graph.n_vars
    dc, dv = graph.dc_max, graph.dv_max

    def decode(llr: jax.Array) -> BpResult:
        B = llr.shape[0]
        dtype = llr.dtype
        eps = jnp.finfo(dtype).eps
        clip_t = jnp.asarray(1.0, dtype) - (eps if clip is None else clip)

        bits0 = (llr < 0).astype(jnp.uint8)  # lratio < 1 (dec.cpp:626)
        unsat0 = _syndrome_unsat(bits0.astype(jnp.int32), check_vars, check_mask)
        done0 = unsat0 == 0

        # v2c messages, check-major [B, M*dc]; init to channel LLR of the
        # edge's variable (Init_Belief_Propagation: e->pr = lratio[j]).
        v0 = jnp.take(llr, jnp.maximum(check_vars, 0).reshape(-1), axis=1)

        def cond(state):
            n, _, _, _, done, _ = state
            if not early_stop:
                return n < max_iter
            return (n < max_iter) & ~jnp.all(done)

        def body(state):
            n, v2c, bits, iters, done, unsat = state
            c2v = _check_messages(v2c.reshape(B, M, dc), check_mask, clip_t)
            # optimization_barrier between the pipeline stages: keeps
            # XLA from fusing the check update into/through the
            # 147k-index gathers, which bloats compile time
            c2v = jax.lax.optimization_barrier(c2v)
            c2v_flat = c2v.reshape(B, M * dc)
            c2v_pad = jnp.concatenate([c2v_flat, jnp.zeros((B, 1), dtype)], axis=1)
            cv = jnp.take(c2v_pad, var_edge_ids, axis=1).reshape(B, N, dv)
            cv = jax.lax.optimization_barrier(cv)
            post = llr + jnp.sum(cv, axis=-1)  # [B, N]
            # pr <= 1 decision with NaN -> 1 (dec.cpp:676-686): ~(post > 0)
            # is True for both post <= 0 and NaN.
            new_bits = (~(post > 0)).astype(jnp.uint8)
            v2c_vm = post[:, :, None] - cv  # [B, N, dv]
            v2c_vm = jax.lax.optimization_barrier(v2c_vm)
            v2c_vm_pad = jnp.concatenate(
                [v2c_vm.reshape(B, N * dv), jnp.zeros((B, 1), dtype)], axis=1
            )
            new_v2c = jnp.take(v2c_vm_pad, edge_perm, axis=1)

            new_unsat = _syndrome_unsat(new_bits.astype(jnp.int32), check_vars, check_mask)
            newly_done = (new_unsat == 0) & ~done
            bits = jnp.where(done[:, None], bits, new_bits)
            unsat = jnp.where(done, unsat, new_unsat)
            iters = jnp.where(done, iters, n + 1)
            done = done | newly_done
            return (n + 1, new_v2c, bits, iters, done, unsat)

        state = (
            jnp.int32(0),
            v0,
            bits0,
            jnp.zeros(B, jnp.int32),
            done0,
            unsat0,
        )
        n, _, bits, iters, done, unsat = jax.lax.while_loop(cond, body, state)
        return BpResult(bits=bits, success=done, iterations=iters, unsat=unsat)

    return jax.jit(decode)


# ---------------------------------------------------------------------------
# Blocked (protograph) decoder: message routing as one-hot matmuls
# ---------------------------------------------------------------------------


def bp_decode_blocked(
    code,
    llr: jax.Array,
    max_iter: int = 200,
    early_stop: bool = True,
    mode: Optional[str] = None,
) -> BpResult:
    """Flooding sum-product BP for permutation-blocked codes
    (``models.blocked.BlockedCode``), the fast path for the deployed
    RS-LDPC and any protograph/QC code.

    Identical math and decision semantics to :func:`bp_decode`, but the
    two 147k-element message gathers per iteration become batched q x q
    one-hot matmuls, and the routing linearity folds the variable update
    into ``route(post) - c2v`` — the syndrome comes free from the sign of
    the routed posteriors.

    Modes, each with its matmul precision stated (platform-independent):

    - ``"exact"`` (default): f32 messages, ``Precision.HIGHEST`` one-hot
      matmuls — bit-exact routing (0/1 factors), hard decisions agree
      with :func:`bp_decode` up to f32 reduction-order rounding of the
      same sums.
    - ``"fast"``: f32 messages routed through bf16 operands with f32
      accumulation — one bf16 rounding (relative error <= 2^-9) per
      routed message; validated by FER parity, not bitwise equality.
    - ``"bf16"``: bf16 message storage and routing with f32 check-node
      math and f32 posterior accumulation — a software analogue of the
      reference's quantized decoders (dec.cpp Run_MSA_Decoder), validated
      by FER parity on trial-like workloads rather than bitwise equality.

    LLRs must be finite; non-finite inputs are sanitized (NaN -> tiny
    negative, i.e. the reference's NaN->bit-1 rule; +/-inf clipped).
    """
    if mode is None:
        mode = "exact"
    # routing tensors are jit *arguments*, not closed-over constants: the
    # deployed operators are 151 MB and must not be baked into the HLO
    return _bp_blocked_jit(code, max_iter, early_stop, mode)(
        llr, *routing_operands(code, mode)
    )


BLOCKED_MODES = ("exact", "fast", "bf16")


def routing_operands(code, mode: str):
    """(R_vc, A_sum) one-hot routing operators in the dtype ``mode``
    routes with (one-hots are exact in bf16)."""
    if mode not in BLOCKED_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    R_vc, A_sum = code.routing_tables()
    if mode in ("fast", "bf16"):
        return R_vc.astype(jnp.bfloat16), A_sum.astype(jnp.bfloat16)
    return R_vc, A_sum


@functools.lru_cache(maxsize=32)
def _bp_blocked_jit(code, max_iter: int, early_stop: bool, mode: str):
    import jax.lax as lax

    canon_idx = jnp.asarray(code.canonical_gather())
    ext_idx = jnp.asarray(code.external_gather())
    G, J, q = code.G, code.J, code.q
    N = code.n_vars
    # exact: f32 operands at HIGHEST (full f32, no TF32 or bf16 passes).
    # fast/bf16: bf16 operands (one-hots exact, messages rounded to bf16,
    # relative error <= 2^-9) with f32 accumulation; products of bf16
    # values are exact in f32, so DEFAULT precision loses nothing more.
    prec = lax.Precision.HIGHEST if mode == "exact" else lax.Precision.DEFAULT
    op_dtype = jnp.float32 if mode == "exact" else jnp.bfloat16
    msg_dtype = jnp.bfloat16 if mode == "bf16" else jnp.float32

    def route_to_checks(R_vc, x, B):
        # [G,J,q,q] @ (broadcast [J,q,B]) -> [G,J,q,B]
        return lax.dot_general(
            R_vc, jnp.broadcast_to(x.astype(op_dtype), (G, J, q, B)),
            (((3,), (2,)), ((0, 1), (0, 1))),
            precision=prec, preferred_element_type=msg_dtype,
        )

    def sum_to_vars(A_sum, x):
        # route check messages to the variable side AND sum over the G
        # cosets in one matmul per column group: [J,q,G*q] @ [J,G*q,B]
        B = x.shape[-1]
        stacked = x.transpose(1, 0, 2, 3).reshape(J, G * q, B).astype(op_dtype)
        return lax.dot_general(
            A_sum, stacked, (((2,), (1,)), ((0,), (0,))),
            precision=prec, preferred_element_type=jnp.float32,
        )  # [J, q, B] — posterior sums always accumulate in f32

    def unsat_from_signs(bits_pc):
        # bits_pc: [G, J, q, B] int32 decisions at the check side
        parity = jnp.sum(bits_pc, axis=1) % 2             # [G, q, B]
        return jnp.sum(parity, axis=(0, 1)).astype(jnp.int32)  # [B]

    def decode(llr: jax.Array, R_vc, A_sum) -> BpResult:
        B = llr.shape[0]
        dtype = llr.dtype
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        llr = jnp.where(jnp.isnan(llr), jnp.asarray(-1e-30, dtype), jnp.clip(llr, -big, big))
        # tanh clip: keep |te| strictly below 1 so 2*atanh stays finite.
        # In bf16 message mode the c2v magnitude cap must survive the bf16
        # round-trip, so back off further from 1.
        clip_t = jnp.asarray(1.0, jnp.float32) - (
            jnp.finfo(jnp.float32).eps if mode != "bf16" else 1e-5
        )

        llrT = llr[:, canon_idx].T.reshape(J, q, B)   # canonical, var-side
        llrT_m = llrT.astype(msg_dtype)
        v2c0 = route_to_checks(R_vc, llrT_m, B)       # init: e->pr = lratio[j]
        bits0 = (llrT < 0).astype(jnp.uint8)          # lratio < 1 (dec.cpp:626)
        unsat0 = unsat_from_signs((v2c0 < 0).astype(jnp.int32))
        done0 = unsat0 == 0

        def cond(state):
            n, _, _, _, done, _ = state
            if not early_stop:
                return n < max_iter
            return (n < max_iter) & ~jnp.all(done)

        def body(state):
            n, v2c, bits, iters, done, unsat = state
            t = jnp.tanh(v2c.astype(jnp.float32) * 0.5)
            te = _exclusive_prod(t, axis=1)           # over the J edges/check
            te = jnp.clip(te, -clip_t, clip_t)
            c2v = (jnp.log1p(te) - jnp.log1p(-te)).astype(msg_dtype)  # [G,J,q,B]
            c2v = jax.lax.optimization_barrier(c2v)
            post = llrT + sum_to_vars(A_sum, c2v)     # [J, q, B] f32
            post = jax.lax.optimization_barrier(post)
            post_pc = route_to_checks(R_vc, post.astype(msg_dtype), B)  # [G,J,q,B]
            new_v2c = post_pc - c2v                   # exclusive: route is linear
            # pr <= 1 decision with NaN -> 1: ~(post > 0)
            new_bits = (~(post > 0)).astype(jnp.uint8)
            new_unsat = unsat_from_signs((~(post_pc > 0)).astype(jnp.int32))
            newly_done = (new_unsat == 0) & ~done
            bits = jnp.where(done[None, None, :], bits, new_bits)
            unsat = jnp.where(done, unsat, new_unsat)
            iters = jnp.where(done, iters, n + 1)
            done = done | newly_done
            return (n + 1, new_v2c, bits, iters, done, unsat)

        state = (jnp.int32(0), v2c0, bits0, jnp.zeros(B, jnp.int32), done0, unsat0)
        n, _, bits, iters, done, unsat = jax.lax.while_loop(cond, body, state)
        bits_ext = bits.reshape(N, B).T[:, ext_idx]   # canonical -> shipped order
        return BpResult(bits=bits_ext, success=done, iterations=iters, unsat=unsat)

    return jax.jit(decode)


# ---------------------------------------------------------------------------
# Convenience host API
# ---------------------------------------------------------------------------


def decode_llrs(graph: LdpcGraph, llrs: np.ndarray, max_iter: int = 200) -> BpResult:
    """Host entry: accepts [N] or [B, N] numpy LLRs, returns device results."""
    llrs = jnp.asarray(np.atleast_2d(np.asarray(llrs, dtype=np.float32)))
    return bp_decode(graph, llrs, max_iter=max_iter)


def bp_posteriors(graph: LdpcGraph, llr: jax.Array, iters: int) -> jax.Array:
    """Soft-output BP: run ``iters`` flooding iterations and return the
    posterior LLRs [B, N] (channel + all check messages). The soft
    interface component decoders need for turbo-style product decoding
    (extrinsic = posterior - input)."""
    return _bp_post_jit(graph, iters)(llr)


@functools.lru_cache(maxsize=32)
def _bp_post_jit(graph: LdpcGraph, iters: int):
    tables = graph.device_tables()
    check_vars = tables["check_vars"]
    check_mask = tables["check_mask"]
    var_edge_ids = tables["var_edge_ids"].reshape(-1)
    edge_perm = tables["edge_perm"]
    M, N = graph.n_checks, graph.n_vars
    dc, dv = graph.dc_max, graph.dv_max

    def run(llr):
        B = llr.shape[0]
        dtype = llr.dtype
        clip_t = jnp.asarray(1.0, dtype) - jnp.finfo(dtype).eps
        v0 = jnp.take(llr, jnp.maximum(check_vars, 0).reshape(-1), axis=1)

        def body(i, carry):
            v2c, _ = carry
            c2v = _check_messages(v2c.reshape(B, M, dc), check_mask, clip_t)
            c2v = jax.lax.optimization_barrier(c2v)
            c2v_pad = jnp.concatenate([c2v.reshape(B, M * dc), jnp.zeros((B, 1), dtype)], axis=1)
            cv = jnp.take(c2v_pad, var_edge_ids, axis=1).reshape(B, N, dv)
            post = llr + jnp.sum(cv, axis=-1)
            v2c_vm = post[:, :, None] - cv
            v2c_pad = jnp.concatenate(
                [v2c_vm.reshape(B, N * dv), jnp.zeros((B, 1), dtype)], axis=1
            )
            return jnp.take(v2c_pad, edge_perm, axis=1), post

        _, post = jax.lax.fori_loop(0, iters, body, (v0, llr))
        return post

    return jax.jit(run)
