"""Dense edge-table representation of a Tanner graph for batched decoding.

The reference decoder walks doubly-linked per-edge lists
(``LDPC_dec/ldpc/mod2sparse.h:42-118``, traversed in ``dec.cpp:632-694``).
Here the graph instead becomes static dense gather tables:

- ``check_vars``  [M, dc_max]: the variable index of each check-side edge
  slot (padded with -1);
- ``var_edge_ids`` [N, dv_max]: the flat check-major edge id of each
  variable-side edge slot (padded with E, a dummy slot);
- ``edge_perm``   [E]: for each check-major edge, its position in the
  flattened variable-major layout — the scatter that routes
  variable-to-check messages back to check-major order.

Messages live in two flat layouts ([B, E] check-major / variable-major);
one gather per direction per BP iteration replaces all pointer chasing.
For regular codes (the deployed RS-LDPC is (dv=8, dc=72)-regular) the
tables are exact with zero padding.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..utils.io_formats import SparseBinaryMatrix


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: cache key for jits
class LdpcGraph:
    """Static decoding tables for one LDPC code. Numpy-held; converted to
    device arrays lazily by the decoder (they are compile-time constants
    from XLA's point of view when closed over under jit)."""

    n_checks: int
    n_vars: int
    dc_max: int
    dv_max: int
    n_edges: int
    check_vars: np.ndarray      # [M, dc_max] int32, -1 padding
    check_mask: np.ndarray      # [M, dc_max] bool
    var_edge_ids: np.ndarray    # [N, dv_max] int32, == n_edges padding
    var_mask: np.ndarray        # [N, dv_max] bool
    edge_perm: np.ndarray       # [E] int32: check-major edge -> var-major slot
    edge_var: np.ndarray        # [E] int32: variable of each check-major edge
    regular: bool
    # permutation-block (protograph) structure, when the code has one —
    # enables the one-hot routing decoders (ops/bp.bp_decode_blocked)
    blocked: object = None

    @classmethod
    def from_sparse(cls, H: SparseBinaryMatrix, detect_blocked: bool = True) -> "LdpcGraph":
        M, N = H.n_rows, H.n_cols
        row_w = H.row_weights()
        col_w = H.col_weights()
        dc = int(row_w.max(initial=0))
        dv = int(col_w.max(initial=0))
        E = H.nnz

        check_vars = np.full((M, dc), -1, dtype=np.int32)
        check_mask = np.zeros((M, dc), dtype=bool)
        slot = np.concatenate([np.arange(w) for w in row_w]) if E else np.zeros(0, np.int64)
        rows = np.repeat(np.arange(M), row_w)
        check_vars[rows, slot] = H.indices
        check_mask[rows, slot] = True

        # Edge id in check-major flat order is simply its position in the
        # (row-sorted) CSR stream mapped into the padded [M, dc] grid.
        edge_ids_cm = np.full((M, dc), -1, dtype=np.int64)
        edge_ids_cm[rows, slot] = rows * dc + slot
        flat_ids = rows * dc + slot  # [E] in CSR order

        # Variable-major tables: group edges by variable (stable in
        # check order, matching the reference's column-list order which is
        # sorted by row index, mod2sparse.cpp insertion).
        order = np.argsort(H.indices, kind="stable")
        var_sorted = H.indices[order]
        ids_sorted = flat_ids[order]
        var_edge_ids = np.full((N, dv), M * dc, dtype=np.int32)
        var_mask = np.zeros((N, dv), dtype=bool)
        vslot = np.concatenate([np.arange(w) for w in col_w]) if E else np.zeros(0, np.int64)
        var_edge_ids[var_sorted, vslot] = ids_sorted
        var_mask[var_sorted, vslot] = True

        # edge_perm: padded-check-major edge id -> flat var-major position.
        perm = np.full(M * dc, N * dv, dtype=np.int32)
        perm[ids_sorted] = var_sorted * dv + vslot

        regular = bool(np.all(row_w == dc) and np.all(col_w == dv))
        blocked = None
        if detect_blocked and regular:
            from .blocked import BlockedCode

            blocked = BlockedCode.detect(H)
        return cls(
            blocked=blocked,
            n_checks=M,
            n_vars=N,
            dc_max=dc,
            dv_max=dv,
            n_edges=int(E),
            check_vars=check_vars,
            check_mask=check_mask,
            var_edge_ids=var_edge_ids,
            var_mask=var_mask,
            edge_perm=perm,
            edge_var=check_vars.reshape(-1),
            regular=regular,
        )

    def device_tables(self):
        """The gather tables as jnp arrays (cached per graph instance)."""
        cached = getattr(self, "_device_tables", None)
        if cached is None:
            cached = {
                "check_vars": jnp.asarray(self.check_vars),
                "check_mask": jnp.asarray(self.check_mask),
                "var_edge_ids": jnp.asarray(self.var_edge_ids),
                "var_mask": jnp.asarray(self.var_mask),
                "edge_perm": jnp.asarray(self.edge_perm),
            }
            object.__setattr__(self, "_device_tables", cached)
        return cached
