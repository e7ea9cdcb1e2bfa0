"""Device mesh construction for the decoding framework.

Replacement for the reference's (compiled-out) MPI frame
parallelism (``LDPC_dec/ldpc/DNA_main.cpp:1187-1193``, ``Set_FrameNum``
per-rank splitting at ``:629-651``): a 2-D ``jax.sharding.Mesh`` with

- axis ``cw``   — codeword/trial batch data parallelism (the domain's DP;
  replaces the 272-sequential-process loop, decoder.py:553-558), intended
  to span hosts at scale;
- axis ``graph`` — Tanner-graph parallelism: checks partitioned across
  devices (cosets of the RS-LDPC construction give perfectly balanced
  shards), message reductions are one psum.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CW_AXIS = "cw"
GRAPH_AXIS = "graph"


def build_mesh(
    n_graph: int | None = None,
    devices: list | None = None,
    max_graph: int = 8,
) -> Mesh:
    """Build a (cw, graph) mesh over the available devices.

    ``n_graph`` defaults to the largest power-of-two divisor of the device
    count that is <= max_graph (gamma=8 cosets for the deployed code).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_graph is None:
        n_graph = 1
        while n_graph * 2 <= max_graph and n % (n_graph * 2) == 0:
            n_graph *= 2
    if n % n_graph:
        raise ValueError(f"{n} devices not divisible by graph axis {n_graph}")
    arr = np.asarray(devices).reshape(n // n_graph, n_graph)
    return Mesh(arr, (CW_AXIS, GRAPH_AXIS))


def llr_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(CW_AXIS, None))


def check_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [M, ...] check-side tables: rows over the graph axis."""
    return NamedSharding(mesh, P(GRAPH_AXIS))
