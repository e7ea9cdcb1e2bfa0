"""Accelerator DNA data-storage decoding framework.

A from-scratch JAX/XLA re-design of the capabilities of the
reference pipeline sjpark0905/DNA-LDPC-codes (see SURVEY.md): RS-LDPC code
construction, batched flooding sum-product LDPC belief propagation,
RS(8,4)/GF(16) index decoding, soft-information (LLR) extraction over
clustered variable-length sequencing reads, pair-HMM-based multiple
sequence alignment (MUSCLE replacement), epsilon-annealing re-decode, and
multi-device sharding over device meshes.
"""

__version__ = "0.1.0"


import os

# Persistent compilation cache, so the n=18432 decoder and pair-HMM
# executables survive process restarts: JAX_COMPILATION_CACHE_DIR when it
# is set (JAX reads it itself), else one fixed directory inside the
# checkout (a path that moves never hits).
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_persistent_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


_enable_persistent_compile_cache()
