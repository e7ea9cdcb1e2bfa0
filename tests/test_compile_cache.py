"""Persistent compile-cache placement (dna_ldpc_tpu/__init__.py):
JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed directory
inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/some/where/else"])
def test_compile_cache_dir(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c",
         "import dna_ldpc_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[-1]
    assert out == (env_dir or os.path.join(REPO, ".jax_cache"))
