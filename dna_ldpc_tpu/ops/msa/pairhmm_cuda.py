"""Hopper pair-HMM kernel (``native/pairhmm.cu``) called through jax.ffi.

The CUDA source is compiled with ``nvcc`` for compute capability 9.0a
into ``build/libpairhmm.so`` at first use (or ahead of time with
``python -m dna_ldpc_tpu.ops.msa.pairhmm_cuda``), then registered as an
XLA FFI target. The kernel computes what ``pairhmm._post_ea_xla`` does —
sparsified match posteriors [P, Lmax, Lmax] and bf16-rounded MEA scores
[P] — with one thread block per pair and the DP state in shared memory.
It has no interpret mode: on the CPU the XLA formulation runs instead
(``pairhmm.batch_post_ea``), and that formulation is the reference the
kernel is compared with on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from .pairhmm import _trans_reversed, nucleo_params

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
SOURCE = os.path.join(_REPO, "native", "pairhmm.cu")
LIBRARY = os.path.join(_REPO, "build", "libpairhmm.so")
TARGET = "dna_ldpc_pairhmm_post_ea"


def build_command(out: str = LIBRARY) -> list[str]:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
        "-o", out, SOURCE,
    ]


def build(force: bool = False) -> str:
    """Compile the kernel library unless an up-to-date one exists."""
    fresh = os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)
    if force or not fresh:
        os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
        tmp = LIBRARY + f".{os.getpid()}.tmp"
        proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {SOURCE}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.PairHmmPostEa), platform="CUDA"
    )


@functools.lru_cache(maxsize=None)
def kernel_params() -> np.ndarray:
    """The kernel's 95 parameters: start[5] | trans6[6,5] | trans_rev[6,5]
    | match[5,5] | ins[5], the XLA formulation's own float32 tables."""
    start, trans6, match, ins = nucleo_params()
    return np.concatenate(
        [start, trans6.ravel(), _trans_reversed().ravel(), match.ravel(), ins]
    ).astype(np.float32)


def _ffi_post_ea(X, Y, lx, ly, params):
    _register()
    P, L = X.shape
    return jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((P, L, L), jnp.float32),
            jax.ShapeDtypeStruct((P,), jnp.float32),
        ),
    )(X, Y, lx, ly, params)


def post_ea_cuda(X, Y, lx, ly):
    """(post [P, Lmax, Lmax], ea [P]) device arrays from the packed codes
    and lengths of ``pairhmm.encode_pairs``."""
    return _ffi_post_ea(
        jnp.asarray(X, jnp.int32), jnp.asarray(Y, jnp.int32),
        jnp.asarray(lx, jnp.int32), jnp.asarray(ly, jnp.int32),
        jnp.asarray(kernel_params()),
    )


if __name__ == "__main__":
    print(build(force=True))
