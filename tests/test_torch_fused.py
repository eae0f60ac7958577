"""K2's plain version against the JAX package's fused Pallas kernel in
interpret mode: all six step variants, with valid-row windows, iceberg
thresholds, pad counts, block offsets and CbO parent/lowrow operands.
Closures, supports and keep masks must be bit-equal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import frontier as ref_fkern
from repro_torch.core import bitset
from repro_torch.kernels import frontier as fkern

from _torch_reference import random_bits, subset_candidates, t, u32

WINDOWS = {
    # (n_valid, min_sup, n_pad, row_off) as functions of (B, N)
    "full": lambda B, N: (B, 1, 0, 0),
    "window": lambda B, N: (B - B // 3, N // 20, 5, 0),
    "offset": lambda B, N: (B // 2 + 1, 3, 1, B // 4),
    "empty": lambda B, N: (0, 0, 0, 0),
}


def _case(N: int, B: int, n_attrs: int, seed: int):
    rng = np.random.default_rng(seed)
    W = bitset.n_words(n_attrs)
    mask = bitset.attr_mask(n_attrs, W)
    rows = random_bits(rng, N, W, 0.7) & mask
    cands = subset_candidates(rng, rows, B) & mask
    parent = cands & random_bits(rng, B, W, 0.6)
    lowrow = random_bits(rng, B, W, 0.3) & mask
    return rows, cands, mask[None, :], parent, lowrow


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("variant", sorted(fkern.VARIANTS))
def test_fused_step_plain_matches_pallas_interpret(variant, window):
    N, B, n_attrs = 512, 16, 45
    rows, cands, mask, parent, lowrow = _case(N, B, n_attrs, seed=len(variant))
    iceberg, cbo, _ = fkern.VARIANTS[variant]
    assert ref_fkern.VARIANTS[variant] == fkern.VARIANTS[variant]
    scalars = WINDOWS[window](B, N)
    ref_kw = dict(iceberg=iceberg, cbo=cbo, interpret=True)
    kw = dict(iceberg=iceberg, cbo=cbo)
    if cbo:
        ref_kw.update(parent=jnp.asarray(parent), lowrow=jnp.asarray(lowrow))
        kw.update(parent=t(parent), lowrow=t(lowrow))
    want = ref_fkern.fused_closure_call(
        jnp.asarray(rows), jnp.asarray(cands), jnp.asarray(mask),
        ref_fkern.pack_scalars(*scalars), **ref_kw)
    for fn in (fkern.fused_step_plain, fkern.fused_step):
        gc, sup, keep = fn(t(rows), t(cands), t(mask), fkern.pack_scalars(*scalars), **kw)
        np.testing.assert_array_equal(u32(gc), u32(want[0]))
        np.testing.assert_array_equal(sup.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("N,B,n_attrs", [(256, 8, 1), (768, 24, 100), (256, 8, 160)])
def test_fused_step_shapes_match_pallas_interpret(N, B, n_attrs):
    rows, cands, mask, parent, lowrow = _case(N, B, n_attrs, seed=N + n_attrs)
    scalars = (B - 1, 2, 3, 1)
    for iceberg, cbo in ((True, True), (False, False)):
        ref_kw, kw = {}, {}
        if cbo:
            ref_kw = dict(parent=jnp.asarray(parent), lowrow=jnp.asarray(lowrow))
            kw = dict(parent=t(parent), lowrow=t(lowrow))
        want = ref_fkern.fused_closure_call(
            jnp.asarray(rows), jnp.asarray(cands), jnp.asarray(mask),
            ref_fkern.pack_scalars(*scalars), iceberg=iceberg, cbo=cbo,
            interpret=True, **ref_kw)
        got = fkern.fused_step(t(rows), t(cands), t(mask), scalars,
                               iceberg=iceberg, cbo=cbo, **kw)
        np.testing.assert_array_equal(u32(got[0]), u32(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("scalars", [(5,), (5, 2), (5, 2, 1), (5, 2, 1, 3)])
def test_pack_scalars_matches_reference(scalars):
    want = np.asarray(ref_fkern.pack_scalars(*scalars))
    assert list(fkern.pack_scalars(*scalars)) == want.tolist()
