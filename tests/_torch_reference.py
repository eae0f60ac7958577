"""Parity harness for the tests/test_torch_*.py files: the JAX package's
reference runs, fed the same numpy inputs as the port.

On jax >= 0.9, ``repro.dist.collectives._axis_size`` calls
``jax.core.axis_frame``, which no longer exists, so every ``ClosureEngine``
round of the reference raises.  The module-scoped ``jax_reference``
fixture binds it with ``monkeypatch.setattr`` while one parity module's
tests run, then removes it and clears jax's caches, so nothing traced
under the binding outlives the module.  It is never installed at import
time or in a conftest: the JAX package's own tests, which can run in the
same worker, must keep failing where the installed jax breaks them.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro_torch.device import device_bits, host_bits
from repro_torch.interop import context_from_arrays

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            jax.core, "axis_frame", lambda name: jax.lax.axis_size(name), raising=False
        )
        yield
    jax.clear_caches()


def port_context(ref_ctx):
    """The port's FormalContext over the very rows of a reference context."""
    return context_from_arrays(ref_ctx.rows, ref_ctx.n_objects, ref_ctx.n_attrs)


def t(arr: np.ndarray) -> torch.Tensor:
    """uint32 words → the port's int32 view on the CPU."""
    return device_bits(arr, CPU)


def u32(x) -> np.ndarray:
    """A port int32 tensor or a reference array → uint32 numpy."""
    if isinstance(x, torch.Tensor):
        return host_bits(x)
    return np.asarray(x).astype(np.uint32)


def random_bits(rng, n: int, W: int, density: float) -> np.ndarray:
    """Seeded random packed rows [n, W] (uint32, bit 31 included)."""
    dense = rng.random((n, W * 32)) < density
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (dense.reshape(n, W, 32).astype(np.uint32) * weights).sum(
        -1, dtype=np.uint32
    )


def subset_candidates(rng, rows: np.ndarray, B: int, keep: float = 0.2) -> np.ndarray:
    """Subsets of random rows (non-trivial supports), with the empty and the
    all-ones candidate at the two ends."""
    W = rows.shape[1]
    cands = rows[rng.integers(0, rows.shape[0], size=B)] & random_bits(rng, B, W, keep)
    cands[0] = 0
    if B > 1:
        cands[-1] = 0xFFFFFFFF
    return cands
