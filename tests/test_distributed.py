"""Multi-process (multi-host-style) distribution: 2 spawned CPU
processes with a loopback jax.distributed coordinator drive the sharded
decoder over a process-spanning mesh (BASELINE config 5 scaffolding;
reference analogue: the compiled-out MPI backend, DNA_main.cpp:1187-1193).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from dna_ldpc_tpu.parallel.distributed import split_trials

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
import numpy as np

# independent CPU runtime per process: 4 virtual devices each
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

from dna_ldpc_tpu.parallel import distributed
from dna_ldpc_tpu.parallel.sharded_bp import make_sharded_decoder
from dna_ldpc_tpu.models import LdpcGraph
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc

coord, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
kind = sys.argv[4] if len(sys.argv) > 4 else "toy"
distributed.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8  # 2 processes x 4 virtual CPU devices

mesh = distributed.global_mesh(max_graph=4)
assert mesh.devices.shape == (2, 4)
# graph axis stays within one process (no DCN inside the BP psum)
for row in mesh.devices:
    assert len({d.process_index for d in row}) == 1

if kind == "flagship":
    # the DEPLOYED 2048x18432 graph crossing a process boundary
    # (COLLECT_MPI intent, DNA_main.cpp:1187-1193): codewords split
    # across the two processes, the n-axis sharded within each
    from dna_ldpc_tpu.models.rs_ldpc import dna_storage_pchk

    H = dna_storage_pchk()
    max_iter = 2
else:
    H = build_rs_ldpc(4, 8, 4)
    max_iter = 20
graph = LdpcGraph.from_sparse(H)
decode = make_sharded_decoder(graph, mesh, max_iter=max_iter)

rng = np.random.default_rng(0)
mag = np.log(0.98 / 0.02)
B = 4
cov = rng.poisson(3.7, (B, H.n_cols))
errs = rng.binomial(cov, 0.02)
llr = ((cov - 2 * errs) * mag).astype(np.float32)

llr_dev = distributed.process_local_batch(llr, mesh)
result = decode(llr_dev)
jax.block_until_ready(result.bits)

# gather the globally-sharded outputs back to every host
from jax.experimental import multihost_utils
bits = np.asarray(multihost_utils.process_allgather(result.bits, tiled=True))
success = np.asarray(multihost_utils.process_allgather(result.success, tiled=True))
if pid == 0:
    np.savez(out_path, bits=bits, success=success)
print("WORKER_OK", pid, flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_process(tmp_path, kind: str, timeout: int) -> str:
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    out_path = str(tmp_path / f"out_{kind}.npz")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid), out_path, kind],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"WORKER_OK {pid}" in out
    return out_path


def _reference_decode(H, max_iter):
    import jax.numpy as jnp

    from dna_ldpc_tpu.models import LdpcGraph
    from dna_ldpc_tpu.ops.bp import bp_decode

    graph = LdpcGraph.from_sparse(H)
    rng = np.random.default_rng(0)
    mag = np.log(0.98 / 0.02)
    cov = rng.poisson(3.7, (4, H.n_cols))
    errs = rng.binomial(cov, 0.02)
    llr = ((cov - 2 * errs) * mag).astype(np.float32)
    return bp_decode(graph, jnp.asarray(llr), max_iter=max_iter)


@pytest.mark.slow
def test_two_process_sharded_decode(tmp_path):
    out_path = _run_two_process(tmp_path, "toy", 420)

    # the 2-process result matches a single-process decode bit-for-bit
    data = np.load(out_path)
    from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc

    ref = _reference_decode(build_rs_ldpc(4, 8, 4), 20)
    np.testing.assert_array_equal(data["bits"], np.asarray(ref.bits))
    np.testing.assert_array_equal(data["success"], np.asarray(ref.success))


@pytest.mark.slow
def test_two_process_flagship_decode(tmp_path):
    """The DEPLOYED 2048x18432 graph across a real process boundary
    (max_iter=2 keeps the CPU cost bounded), bit-identical to the
    single-process decoder."""
    out_path = _run_two_process(tmp_path, "flagship", 900)

    data = np.load(out_path)
    from dna_ldpc_tpu.models.rs_ldpc import dna_storage_pchk

    ref = _reference_decode(dna_storage_pchk(), 2)
    np.testing.assert_array_equal(data["bits"], np.asarray(ref.bits))
    np.testing.assert_array_equal(data["success"], np.asarray(ref.success))


def test_split_trials_covers_all_ranks():
    """Set_FrameNum per-rank split semantics (DNA_main.cpp:629-651)."""
    for n, k in ((10, 3), (272, 8), (5, 5), (3, 4)):
        seen = []
        for pid in range(k):
            seen.extend(split_trials(n, k, pid))
        assert seen == list(range(n))
        sizes = [len(split_trials(n, k, pid)) for pid in range(k)]
        assert max(sizes) - min(sizes) <= 1
