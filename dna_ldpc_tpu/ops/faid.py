"""Finite-alphabet iterative decoders (FAID).

Batched re-design of the reference's LUT-driven FAID family
(``LDPC_dec/ldpc/dec.cpp:837-1171``): messages live on a small symmetric
level alphabet {-L_s..-L_1, 0, L_1..L_s}; the check node is the usual
sign x min rule; the variable node is an arbitrary *lookup table*
Phi(channel sign, incoming messages) — the nonlinearity that lets FAIDs
beat floating BP in the error floor on column-weight-3 codes.

Engine design: messages are carried as level *values* (small floats) in
the same dense edge tables as the other decoders; the variable-node LUT
is applied as a quantizer over (weighted channel + exclusive message
sums), which expresses every threshold-symmetric FAID: a table
Phi(y, m1..m_{dv-1}) that is symmetric and monotone in the sum collapses
to level thresholds on w*y + sum(m). ``default_faid_rule`` is the
standard 7-level instance; custom (weight, thresholds, levels) tuples
express other published tables.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..models.ldpc_graph import LdpcGraph
from .bp import BpResult, _syndrome_unsat


@dataclasses.dataclass(frozen=True)
class FaidRule:
    """A threshold-symmetric FAID variable-node rule.

    new_level = sign(s) * levels[ #thresholds below |s| ]   with
    s = channel_weight * y + sum(incoming c2v), y = +/-C channel value.
    """

    levels: tuple          # (L1, L2, ..., Ls), positive ascending
    thresholds: tuple      # (T1, ..., Ts): |s| >= T_k -> at least level k
    channel_value: float   # C, the +/-channel magnitude
    channel_weight: float  # w applied to the channel term


def default_faid_rule() -> FaidRule:
    """7-level (3-bit) FAID for column-weight-3 codes: levels {1, 2, 3},
    channel +/-1.5 weighted 1, thresholds placed between level sums."""
    return FaidRule(
        levels=(1.0, 2.0, 3.0),
        thresholds=(0.5, 2.5, 4.5),
        channel_value=1.5,
        channel_weight=1.0,
    )


@dataclasses.dataclass(frozen=True)
class LutRule:
    """An arbitrary 2-input FAID variable-node lookup table for dv=3
    codes — the reference's actual FAID machinery
    (``Variable_FAID_LUT``, dec.cpp:1135-1171; tables dec.cpp:1026-1126).

    ``table[m1+s][m2+s]`` gives the outgoing level for incoming
    check-to-variable messages (m1, m2) when the channel value is
    NEGATIVE; the y >= 0 case is the odd-symmetric image (the reference
    negates inputs and output, dec.cpp:1148-1168). m1/m2 follow the
    variable node's edge order (the reference's column traversal); the
    published tables are symmetric so the order is immaterial for them.

    Decision rule (Decision_FAID, dec.cpp:965-998):
    ``sum = C * recv + sum_k weights[|m_k|] * sign(m_k)`` with
    sign(0) = +1; sum > 0 -> bit 0, sum < 0 -> bit 1, and on a tie the
    reference stores recv (+/-1) into its char codeword array, which its
    ``check()`` treats as a set bit either way (check.cpp/mulvec tests
    ``if (u[j])``) — so a tie decodes as bit 1, preserved here.
    """

    table: tuple            # (2s+1) rows of (2s+1) ints, y < 0 convention
    channel_value: float    # C: 0.5 (type_FAID_weight == 0) or 1.5
    weights: tuple | None = None  # weights[mag], mag 0..s; default all 1

    @property
    def s(self) -> int:
        return (len(self.table) - 1) // 2


# Published LUTs shipped by the reference (dec.cpp FAID_LUT_2 / FAID_LUT_3,
# active — i.e. non-commented — entries, in type_FAID order):
FAID_TABLES: dict[str, tuple] = {
    # "Finite alphabet iterative decoders for LDPC codes surpassing
    # floating-point iterative decoders", Table 1 (5-level)
    "planjery5_t1": (
        (-2, -2, -2, -2, 0),
        (-2, -2, -2, -1, 0),
        (-2, -2, -1, 0, 1),
        (-2, -1, 0, 0, 1),
        (0, 0, 1, 1, 2),
    ),
    # "Finite Alphabet Iterative Decoding of the (155,64,20) Tanner
    # Code", Table V (5-level)
    "tanner5_t5": (
        (-2, -2, -2, -2, 0),
        (-2, -2, -1, -1, 1),
        (-2, -1, -1, 0, 1),
        (-2, -1, 0, 1, 2),
        (0, 1, 1, 2, 2),
    ),
    # "surpassing floating-point", Table 2 (7-level) — NOT expressible as
    # a threshold rule: e.g. rows are not translates of each other
    "planjery7_t2": (
        (-3, -3, -3, -3, -3, -3, -1),
        (-3, -3, -3, -3, -2, -1, 1),
        (-3, -3, -2, -2, -1, -1, 1),
        (-3, -3, -2, -1, 0, 0, 1),
        (-3, -2, -1, 0, 0, 1, 2),
        (-3, -1, -1, 0, 1, 1, 3),
        (-1, 1, 1, 1, 2, 3, 3),
    ),
    # "(155,64,20) Tanner Code", Table VIII (7-level)
    "tanner7_t8": (
        (-3, -3, -3, -3, -3, -3, -1),
        (-3, -3, -3, -3, -2, -1, 1),
        (-3, -3, -2, -2, -1, 0, 1),
        (-3, -3, -2, -1, -1, 1, 2),
        (-3, -2, -1, -1, 0, 1, 2),
        (-3, -1, 0, 1, 1, 1, 2),
        (-1, 1, 1, 2, 2, 2, 3),
    ),
    # third active 7-level entry of FAID_LUT_3 (unattributed in the
    # reference source)
    "faid7_3": (
        (-3, -3, -3, -3, -3, -3, -1),
        (-3, -3, -2, -2, -1, -1, 1),
        (-3, -2, -2, -1, -1, 1, 1),
        (-3, -2, -1, -1, -1, 1, 2),
        (-3, -1, -1, -1, 0, 1, 2),
        (-3, -1, 1, 1, 1, 2, 2),
        (-1, 1, 1, 2, 2, 2, 3),
    ),
}


def lut_rule(name: str = "planjery7_t2", channel_weight_type: int = 1) -> LutRule:
    """A published LUT by name; ``channel_weight_type`` selects C as the
    reference does (0 -> 0.5, else 1.5; dec.cpp:973-980)."""
    return LutRule(
        table=FAID_TABLES[name],
        channel_value=0.5 if channel_weight_type == 0 else 1.5,
    )


def faid_decode(
    graph: LdpcGraph,
    hard_bits,
    max_iter: int = 200,
    rule: "FaidRule | LutRule | None" = None,
) -> BpResult:
    """Decode hard-decision input (BSC) with a finite-alphabet decoder.

    hard_bits: [B, N] 0/1 channel hard decisions. Returns the usual
    BpResult with the reference's syndrome-before-iteration semantics.

    ``rule`` may be a threshold-symmetric :class:`FaidRule` (any dv) or
    an arbitrary-table :class:`LutRule` (dv=3 codes, the reference's
    Run_Finite_Alphabet_Iterative_Decoder)."""
    import jax.numpy as jnp

    rule = rule or default_faid_rule()
    bits = jnp.atleast_2d(jnp.asarray(hard_bits))
    if isinstance(rule, LutRule):
        # every variable node must have degree exactly 3: a padded edge
        # (column degree < dv_max) would feed m=0 into the LUT and add
        # +weights[0] to the decision sum, silently diverging from the
        # reference's real-edge-only loops (dec.cpp:837-1171)
        if graph.dv_max != 3 or not graph.var_mask.all():
            raise ValueError(
                "LutRule FAID requires a code whose every column has weight "
                "exactly 3"
            )
        recv = jnp.where(bits == 0, 1, -1).astype(jnp.float32)
        return _faid_lut_jit(graph, max_iter, rule)(recv)
    y = jnp.where(bits == 0, rule.channel_value, -rule.channel_value).astype(jnp.float32)
    return _faid_jit(graph, max_iter, rule)(y)


@functools.lru_cache(maxsize=16)
def _faid_lut_jit(graph: LdpcGraph, max_iter: int, rule: LutRule):
    import jax
    import jax.numpy as jnp

    tables = graph.device_tables()
    check_vars = tables["check_vars"]
    check_mask = tables["check_mask"]
    var_edge_ids = tables["var_edge_ids"].reshape(-1)
    edge_perm = tables["edge_perm"]
    M, N = graph.n_checks, graph.n_vars
    dc, dv = graph.dc_max, graph.dv_max
    s = rule.s
    width = 2 * s + 1
    lut = np.asarray(rule.table, np.float32)
    if lut.shape != (width, width):
        raise ValueError("LUT must be square (2s+1) x (2s+1)")
    flat_lut = lut.ravel()
    weights = np.asarray(
        rule.weights if rule.weights is not None else np.ones(s + 1), np.float32
    )

    def check_update(v2c):
        B = v2c.shape[0]
        v = v2c.reshape(B, M, dc)
        mag = jnp.where(check_mask[None], jnp.abs(v), jnp.inf)
        # reference sign: msg >= 0 counts as +1 (dec.cpp:917-918)
        neg = jnp.where(check_mask[None], v < 0, False)
        min1 = jnp.min(mag, axis=-1, keepdims=True)
        arg1 = jnp.argmin(mag, axis=-1)
        is_min = jax.nn.one_hot(arg1, dc, dtype=bool)
        min2 = jnp.min(jnp.where(is_min, jnp.inf, mag), axis=-1, keepdims=True)
        excl_min = jnp.where(is_min, min2, min1)
        n_neg = jnp.sum(neg, axis=-1, keepdims=True)
        excl_neg = n_neg - neg.astype(n_neg.dtype)
        sign = 1.0 - 2.0 * (excl_neg % 2).astype(v.dtype)
        return (sign * excl_min).reshape(B, M * dc)

    # for edge k of a dv=3 variable node, the other two incoming edges
    # in column order (the reference's inner traversal, dec.cpp:955-963)
    other_a = np.array([1, 0, 0])
    other_b = np.array([2, 2, 1])

    def decode(recv):
        """recv: [B, N] +/-1 channel hard values."""
        B = recv.shape[0]
        bits0 = (recv < 0).astype(jnp.uint8)
        unsat0 = _syndrome_unsat(bits0.astype(jnp.int32), check_vars, check_mask)
        done0 = unsat0 == 0
        # Init_FAID: v2c = +/-1 per edge (dec.cpp:873-884)
        v0 = jnp.take(recv, jnp.maximum(check_vars, 0).reshape(-1), axis=1)

        def cond(state):
            n, _, _, _, done, _ = state
            return (n < max_iter) & ~jnp.all(done)

        def body(state):
            n, v2c, bits, iters, done, unsat = state
            c2v = check_update(v2c)
            c2v = jax.lax.optimization_barrier(c2v)
            c2v_pad = jnp.concatenate([c2v, jnp.zeros((B, 1), jnp.float32)], axis=1)
            cv = jnp.take(c2v_pad, var_edge_ids, axis=1).reshape(B, N, dv)

            # variable update: Phi(m1, m2 | y) with odd symmetry for
            # y >= 0 (dec.cpp:1148-1168)
            flip = jnp.where(recv >= 0, -1.0, 1.0)[:, :, None]     # [B, N, 1]
            m1 = cv[:, :, other_a] * flip
            m2 = cv[:, :, other_b] * flip
            idx = ((m1 + s) * width + (m2 + s)).astype(jnp.int32)
            v2c_vm = jnp.take(jnp.asarray(flat_lut), idx) * flip

            # Decision_FAID: weighted sign sum with sign(0) = +1; a tie
            # stores recv's +/-1 which check() reads as bit 1
            dsign = jnp.where(cv >= 0, 1.0, -1.0)
            wmag = jnp.take(jnp.asarray(weights), jnp.abs(cv).astype(jnp.int32))
            total = rule.channel_value * recv + jnp.sum(dsign * wmag, axis=-1)
            new_bits = jnp.where(total > 0, 0, 1).astype(jnp.uint8)

            v2c_pad = jnp.concatenate(
                [v2c_vm.reshape(B, N * dv), jnp.zeros((B, 1), jnp.float32)], axis=1
            )
            new_v2c = jnp.take(v2c_pad, edge_perm, axis=1)
            new_unsat = _syndrome_unsat(new_bits.astype(jnp.int32), check_vars, check_mask)
            bits = jnp.where(done[:, None], bits, new_bits)
            unsat = jnp.where(done, unsat, new_unsat)
            iters = jnp.where(done, iters, n + 1)
            done = done | (new_unsat == 0)
            return (n + 1, new_v2c, bits, iters, done, unsat)

        state = (jnp.int32(0), v0, bits0, jnp.zeros(B, jnp.int32), done0, unsat0)
        _, _, bits, iters, done, unsat = jax.lax.while_loop(cond, body, state)
        return BpResult(bits=bits, success=done, iterations=iters, unsat=unsat)

    return jax.jit(decode)


@functools.lru_cache(maxsize=16)
def _faid_jit(graph: LdpcGraph, max_iter: int, rule: FaidRule):
    import jax
    import jax.numpy as jnp

    tables = graph.device_tables()
    check_vars = tables["check_vars"]
    check_mask = tables["check_mask"]
    var_edge_ids = tables["var_edge_ids"].reshape(-1)
    edge_perm = tables["edge_perm"]
    M, N = graph.n_checks, graph.n_vars
    dc, dv = graph.dc_max, graph.dv_max
    levels = np.asarray(rule.levels, np.float32)
    thresholds = np.asarray(rule.thresholds, np.float32)

    def quantize(s):
        """Map s to sign(s) * levels[#thresholds <= |s|], 0 below T1."""
        mag = jnp.abs(s)
        k = jnp.sum(mag[..., None] >= thresholds, axis=-1)  # 0..len(levels)
        lv = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.asarray(levels)])
        return jnp.sign(s) * lv[k]

    def check_update(v2c):
        B = v2c.shape[0]
        v = v2c.reshape(B, M, dc)
        mag = jnp.where(check_mask[None], jnp.abs(v), jnp.inf)
        neg = jnp.where(check_mask[None], v < 0, False)
        min1 = jnp.min(mag, axis=-1, keepdims=True)
        arg1 = jnp.argmin(mag, axis=-1)
        is_min = jax.nn.one_hot(arg1, dc, dtype=bool)
        min2 = jnp.min(jnp.where(is_min, jnp.inf, mag), axis=-1, keepdims=True)
        excl_min = jnp.where(is_min, min2, min1)
        n_neg = jnp.sum(neg, axis=-1, keepdims=True)
        excl_neg = n_neg - neg.astype(n_neg.dtype)
        sign = 1.0 - 2.0 * (excl_neg % 2).astype(v.dtype)
        return (sign * excl_min).reshape(B, M * dc)

    def decode(y):
        """y: [B, N] +/-C channel values."""
        B = y.shape[0]
        bits0 = (y < 0).astype(jnp.uint8)
        unsat0 = _syndrome_unsat(bits0.astype(jnp.int32), check_vars, check_mask)
        done0 = unsat0 == 0
        v0 = quantize(jnp.take(y, jnp.maximum(check_vars, 0).reshape(-1), axis=1))

        def cond(state):
            n, _, _, _, done, _ = state
            return (n < max_iter) & ~jnp.all(done)

        def body(state):
            n, v2c, bits, iters, done, unsat = state
            c2v = check_update(v2c)
            c2v = jax.lax.optimization_barrier(c2v)
            c2v_pad = jnp.concatenate([c2v, jnp.zeros((B, 1), jnp.float32)], axis=1)
            cv = jnp.take(c2v_pad, var_edge_ids, axis=1).reshape(B, N, dv)
            total = rule.channel_weight * y + jnp.sum(cv, axis=-1)  # [B, N]
            new_bits = (~(total > 0)).astype(jnp.uint8)
            # variable update: LUT over channel + exclusive message sum
            v2c_vm = quantize(total[:, :, None] - cv)
            v2c_pad = jnp.concatenate(
                [v2c_vm.reshape(B, N * dv), jnp.zeros((B, 1), jnp.float32)], axis=1
            )
            new_v2c = jnp.take(v2c_pad, edge_perm, axis=1)
            new_unsat = _syndrome_unsat(new_bits.astype(jnp.int32), check_vars, check_mask)
            bits = jnp.where(done[:, None], bits, new_bits)
            unsat = jnp.where(done, unsat, new_unsat)
            iters = jnp.where(done, iters, n + 1)
            done = done | (new_unsat == 0)
            return (n + 1, new_v2c, bits, iters, done, unsat)

        state = (jnp.int32(0), v0, bits0, jnp.zeros(B, jnp.int32), done0, unsat0)
        _, _, bits, iters, done, unsat = jax.lax.while_loop(cond, body, state)
        return BpResult(bits=bits, success=done, iterations=iters, unsat=unsat)

    return jax.jit(decode)
