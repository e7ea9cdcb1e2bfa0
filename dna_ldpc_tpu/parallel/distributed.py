"""Multi-host distribution layer.

Replacement for the reference's compiled-out MPI backend
(``LDPC_dec/ldpc/DNA_main.cpp:12`` mpi.h include, ``:1187-1193``
COLLECT_MPI MPI_Reduce of error counters, ``:629-651`` Set_FrameNum
per-rank frame split): ``jax.distributed`` initialization, a mesh that
spans processes with the codeword/trial axis across hosts and the
Tanner-graph axis inside each host, and the per-rank trial split.

With the global mesh, the sharded decoders in ``parallel/sharded_bp.py``
run unchanged across hosts — their per-iteration ``psum`` stays within
a host for the graph axis, and the scalar early-stop/error reductions
that the reference would have MPI_Reduce'd cross hosts.

Multi-process operation is exercised in CI by spawning N CPU processes
with a loopback coordinator (tests/test_distributed.py) — the same code
path ``jax.distributed`` uses across real hosts.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import CW_AXIS, GRAPH_AXIS


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Initialize the multi-process JAX runtime.

    Arguments default to the standard environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), so a
    launcher can configure ranks purely through the environment — the
    role argv/mpiexec played for the reference's MPI scaffolding.
    No-op when the runtime is already initialized or single-process.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None or not num_processes or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(max_graph: int = 8) -> Mesh:
    """A (cw, graph) mesh over every device of every process.

    Devices are grouped by owning process so the ``graph`` axis (the
    per-iteration psum) never crosses a host boundary: shape
    [n_proc * local // g, g] with g = largest power-of-two divisor of the
    LOCAL device count that is <= max_graph. The ``cw`` axis therefore
    spans processes — codeword batches are the DCN-distributed dimension,
    exactly the reference's per-rank frame split (Set_FrameNum).
    """
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_local = max(
        sum(1 for d in devices if d.process_index == p)
        for p in {d.process_index for d in devices}
    )
    g = 1
    while g * 2 <= max_graph and n_local % (g * 2) == 0:
        g *= 2
    arr = np.asarray(devices).reshape(-1, g)
    return Mesh(arr, (CW_AXIS, GRAPH_AXIS))


def split_trials(n_trials: int, num_processes: int, process_id: int) -> range:
    """Per-rank trial partition (Set_FrameNum, DNA_main.cpp:629-651):
    near-equal contiguous blocks, remainder spread over the first ranks."""
    base, rem = divmod(n_trials, num_processes)
    start = process_id * base + min(process_id, rem)
    return range(start, start + base + (1 if process_id < rem else 0))


def process_local_batch(global_batch: np.ndarray, mesh: Mesh):
    """Build a globally-sharded device array from per-process host data.

    Every process passes the FULL [B, ...] batch (or at least its own
    rows); rows are laid out over the ``cw`` axis and each process ships
    only the rows its devices own — the jax.make_array_from_callback path.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(CW_AXIS, *([None] * (global_batch.ndim - 1))))
    return jax.make_array_from_callback(
        global_batch.shape, sharding, lambda idx: global_batch[idx]
    )
