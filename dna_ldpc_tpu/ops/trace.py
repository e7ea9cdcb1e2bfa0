"""Per-iteration BP state tracing — the decoder's debug observability.

The reference can dump the full evolution of a failing frame: per
iteration, every variable's decision + posterior ratio and every check's
satisfaction (``Save_State``/``Print_Variable_State``/
``Print_word_state``, ``LDPC_dec/ldpc/dec.cpp:1796-1908``, wired from
``DNA_main.cpp:1799-1829``), which together with the RNG replay
machinery forms its manual fault-reproduction workflow (SURVEY.md §5).

Batched equivalent: one ``lax.scan`` over BP iterations that stacks
the per-iteration posterior LLRs, hard decisions, and per-check
syndromes for a whole batch at once — one device dispatch, no state
files. ``format_word_state`` renders the same kind of report the
reference writes (variables that are wrong/oscillating, unsatisfied
checks per iteration).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.ldpc_graph import LdpcGraph
from .bp import _check_messages


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BpTrace:
    posteriors: jax.Array  # [iters, B, N] f32 posterior LLRs
    bits: jax.Array        # [iters, B, N] uint8 hard decisions
    check_unsat: jax.Array # [iters, B, M] bool per-check syndrome
    unsat: jax.Array       # [iters, B] int32 unsatisfied-check counts


def bp_trace(graph: LdpcGraph, llr, iters: int = 20) -> BpTrace:
    """Run ``iters`` flooding BP iterations recording the full state
    evolution. llr: [B, N] (or [N]) channel LLRs, reference sign
    convention (>= 0 <=> bit 0)."""
    llr = jnp.atleast_2d(jnp.asarray(llr, jnp.float32))
    return _bp_trace_jit(graph, iters)(llr)


@functools.lru_cache(maxsize=32)
def _bp_trace_jit(graph: LdpcGraph, iters: int):
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

        def per_check_syndrome(bits):
            g = jnp.take(bits, jnp.maximum(check_vars, 0).reshape(-1), axis=1)
            g = g.reshape(B, M, dc)
            g = jnp.where(check_mask[None], g, 0)
            return (jnp.sum(g, axis=-1) % 2).astype(bool)

        def body(v2c, _):
            c2v = _check_messages(v2c.reshape(B, M, dc), check_mask, clip_t)
            c2v = jax.lax.optimization_barrier(c2v)
            c2v_pad = jnp.concatenate(
                [c2v.reshape(B, M * dc), jnp.zeros((B, 1), dtype)], axis=1
            )
            cv = jnp.take(c2v_pad, var_edge_ids, axis=1).reshape(B, N, dv)
            post = llr + jnp.sum(cv, axis=-1)
            bits = (~(post > 0)).astype(jnp.uint8)
            v2c_vm = post[:, :, None] - cv
            v2c_pad = jnp.concatenate(
                [v2c_vm.reshape(B, N * dv), jnp.zeros((B, 1), dtype)], axis=1
            )
            new_v2c = jnp.take(v2c_pad, edge_perm, axis=1)
            cu = per_check_syndrome(bits.astype(jnp.int32))
            return new_v2c, (post, bits, cu, jnp.sum(cu, axis=-1).astype(jnp.int32))

        _, (posts, bits, cu, unsat) = jax.lax.scan(body, v0, None, length=iters)
        return BpTrace(posteriors=posts, bits=bits, check_unsat=cu, unsat=unsat)

    return jax.jit(run)


def format_word_state(
    trace: BpTrace,
    b: int = 0,
    true_word: np.ndarray | None = None,
    max_vars: int = 64,
) -> str:
    """Text report of one codeword's decode evolution, in the spirit of
    the reference's ``Print_word_state``/``Print_Variable_State`` dumps:
    per-iteration unsatisfied-check counts, and the trajectory of the
    most interesting variables (wrong vs the true word if given,
    otherwise the ones that flip most)."""
    bits = np.asarray(trace.bits)[:, b]      # [T, N]
    posts = np.asarray(trace.posteriors)[:, b]
    unsat = np.asarray(trace.unsat)[:, b]
    T, N = bits.shape
    lines = [f"iterations: {T}   variables: {N}"]
    lines.append("iter  unsat_checks")
    for t in range(T):
        lines.append(f"{t + 1:4d}  {int(unsat[t]):6d}")
    if true_word is not None:
        err = bits != np.asarray(true_word, np.uint8)[None, :]
        interesting = np.nonzero(err.any(axis=0))[0]
        label = "wrong-at-some-iteration"
    else:
        flips = (bits[1:] != bits[:-1]).sum(axis=0)
        interesting = np.argsort(-flips)[: max_vars]
        interesting = interesting[flips[interesting] > 0]
        label = "most-oscillating"
    interesting = interesting[:max_vars]
    lines.append(f"{label} variables ({len(interesting)} shown):")
    for v in interesting:
        traj = "".join(str(int(x)) for x in bits[:, v])
        lines.append(f"  v{int(v):6d}  bits {traj}  final_post {posts[-1, v]:+.3f}")
    return "\n".join(lines)
