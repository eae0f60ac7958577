"""K7 (flash attention, forward) against the JAX package.

The port's wrappers run their plain version (``attention_plain``, the
reference's online-softmax scan in torch) for CPU tensors; it is held
against the reference's Pallas ``flash_attention`` in interpret mode on
every case of ``tests/test_flash_attention.py`` (atol 2e-5, rtol 1e-4 in
float32: sum order only; the bf16 case at that file's 3e-2, since p is
rounded to bf16 in another order) and against the reference's
``blockwise_attention`` with left pads (``valid_from``), on the rows whose
``q_pos >= 0`` — the pad rows, which the reference fills with the mean of
V and never reads, are 0 in the port.  The CUDA kernel itself is held
against this plain version on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models.attention import blockwise_attention as ref_blockwise
from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa

import _torch_reference  # noqa: F401,E402  (one torch thread per test process)

REF_CASES = [  # tests/test_flash_attention.py::test_flash_matches_oracle
    (2, 4, 2, 64, 64, 16, True, None, None),
    (1, 6, 2, 100, 100, 32, True, 32, None),
    (2, 2, 1, 48, 48, 16, True, None, 50.0),
    (1, 4, 4, 33, 70, 8, False, None, None),
    (1, 8, 2, 256, 256, 64, True, 64, 30.0),
    (1, 1, 1, 8, 8, 8, True, None, None),
]


def _case(B, H, KV, S, T, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, KV, T, hd)).astype(np.float32),
            rng.standard_normal((B, KV, T, hd)).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window,cap", REF_CASES)
def test_flash_attention_matches_the_pallas_kernel(B, H, KV, S, T, hd, causal, window, cap):
    q, k, v = _case(B, H, KV, S, T, hd, seed=B + S + hd)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=window, logit_cap=cap, q_blk=32, kv_blk=32)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, window=window, logit_cap=cap)
    assert got.shape == (B, H, S, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("q_blk,kv_blk", [(16, 64), (64, 16), (128, 128)])
def test_flash_attention_matches_at_every_reference_block_shape(q_blk, kv_blk):
    q, k, v = _case(1, 4, 2, 128, 128, 32, seed=7)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_blk=q_blk,
                     kv_blk=kv_blk)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_flash_attention_bf16():
    q, k, v = _case(1, 2, 2, 64, 64, 32, seed=3)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(ref_flash(*bf, q_blk=32, kv_blk=32)).astype(np.float32)
    got = fa.flash_attention(*(torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in bf))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


# The CUDA bf16 body's edges (chip_smoke.py's K7_EDGE_*), here through the
# plain version on the CPU: G query heads per KV head in {1, 2, 3, 4, 8}
# (a CTA serves two heads of one KV head, or two 64-row tiles at G = 1),
# S and T on and beside 64 and 128, one long case, hd 8, 24, 128 and 256,
# windows whose reach ends on a 64-key edge (64, 128, 4096) or beside one.
EDGE_CASES = [  # B, H, KV, S, T, hd, causal, window, cap
    (1, 2, 2, 63, 63, 8, True, None, None),
    (1, 2, 2, 64, 64, 24, True, 64, 50.0),
    (1, 2, 2, 65, 65, 128, True, 65, None),
    (1, 2, 2, 127, 127, 256, True, None, 50.0),
    (1, 2, 2, 128, 128, 8, True, 128, None),
    (1, 2, 2, 129, 129, 24, True, 64, None),
    (1, 4, 2, 63, 63, 128, True, 64, 50.0),
    (1, 4, 2, 65, 65, 256, True, None, None),
    (1, 4, 2, 128, 128, 24, True, 65, 50.0),
    (1, 4, 2, 129, 129, 8, True, 128, None),
    (1, 6, 2, 64, 64, 8, True, None, 50.0),
    (1, 6, 2, 127, 127, 24, True, 64, None),
    (1, 6, 2, 129, 129, 256, True, 65, 50.0),
    (1, 8, 2, 65, 65, 24, True, 128, None),
    (1, 8, 2, 128, 128, 128, True, None, 50.0),
    (1, 16, 2, 63, 63, 256, True, 64, None),
    (1, 16, 2, 129, 129, 8, True, None, 50.0),
    (1, 6, 2, 63, 129, 24, False, None, 50.0),
    (1, 8, 2, 129, 64, 8, False, None, None),
    (1, 4, 2, 4097, 4097, 8, True, 4096, 50.0),
]


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window,cap", EDGE_CASES)
def test_flash_attention_matches_the_pallas_kernel_at_the_tile_edges(B, H, KV, S, T, hd, causal,
                                                                     window, cap):
    q, k, v = _case(B, H, KV, S, T, hd, seed=H + S + T + hd)
    blk = 1024 if S > 1024 else 64
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=window, logit_cap=cap, q_blk=blk, kv_blk=blk)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, window=window, logit_cap=cap)
    assert got.shape == (B, H, S, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def _positions(B, S, valid_from):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return np.where(pos >= np.asarray(valid_from)[:, None], pos, -1).astype(np.int32)


@pytest.mark.parametrize("window,cap,dtype", [
    (None, None, "float32"), (16, None, "float32"), (None, 50.0, "float32"),
    (24, 30.0, "float32"), (16, 50.0, "bfloat16"),
])
def test_blockwise_attention_matches_the_reference_with_left_pads(window, cap, dtype):
    B, S, H, KV, hd = 4, 70, 4, 2, 16
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vf = [0, 5, 69, 40]  # mixed, and one row with a single real token
    pos = _positions(B, S, vf)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    want = np.asarray(ref_blockwise(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                                    window=window, logit_cap=cap, kv_block=32)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
                  for x in (jq, jk, jv))
    got = fa.blockwise_attention(tq, tk, tv, window=window, logit_cap=cap,
                                 valid_from=torch.tensor(vf, dtype=torch.int32))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    real = pos >= 0
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[real], want[real], **tol)
    assert (got[~real] == 0).all()


def _blockwise_against_the_reference(q, k, v, vf, window, cap, kv_block, dtype):
    """The port's blockwise_attention on q, k, v (numpy float32, cast to
    ``dtype`` on both sides) against the reference's at the positions of
    ``vf``: real rows within the tolerance of the left-pad test, pad rows 0."""
    B, S = q.shape[:2]
    pos = _positions(B, S, vf)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    want = np.asarray(ref_blockwise(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                                    window=window, logit_cap=cap, kv_block=kv_block)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
                  for x in (jq, jk, jv))
    got = fa.blockwise_attention(tq, tk, tv, window=window, logit_cap=cap,
                                 valid_from=torch.tensor(vf, dtype=torch.int32))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    real = pos >= 0
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got[real], want[real], **tol)
    assert (got[~real] == 0).all()


@pytest.mark.parametrize("G,S,vf,window,cap,hd,dtype", [
    (1, 129, (63, 64), None, 50.0, 8, "float32"),
    (1, 200, (127, 128), 64, None, 24, "float32"),
    (2, 129, (64, 65), 128, 50.0, 128, "float32"),
    (2, 130, (128, 129), 65, None, 8, "float32"),
    (3, 129, (65, 127), 64, 50.0, 24, "float32"),
    (3, 4097, (129, 0), 4096, 50.0, 8, "float32"),
    (4, 129, (0, 128), None, None, 256, "float32"),
    (8, 65, (63, 64), 64, 50.0, 8, "float32"),
    (2, 129, (64, 63), 64, 50.0, 24, "bfloat16"),
    (1, 129, (127, 128), None, None, 8, "bfloat16"),
])
def test_blockwise_attention_matches_the_reference_at_the_tile_edges(G, S, vf, window, cap, hd,
                                                                     dtype):
    """valid_from on and beside the 64- and 128-row edges, in the model
    layout, against the reference's blockwise_attention (64-key blocks, as
    the kernel's stages; 512 at S = 4097)."""
    B, KV = 2, 2
    rng = np.random.default_rng(G * 1000 + S)
    q = rng.standard_normal((B, S, G * KV, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    _blockwise_against_the_reference(q, k, v, vf, window, cap, 512 if S > 1024 else 64, dtype)


@pytest.mark.parametrize("G", [1, 2, 3])
def test_blockwise_attention_reads_slices_of_a_fused_projection(G):
    """q, k and v as slices of one [B, S, (G + 2) KV, hd] projection: strides
    that no contiguous tensor has.  The same function as on contiguous
    copies (bit for bit), and the reference's."""
    B, S, KV, hd = 2, 129, 2, 24
    rng = np.random.default_rng(40 + G)
    qkv = torch.from_numpy(rng.standard_normal((B, S, (G + 2) * KV, hd)).astype(np.float32))
    q, k, v = qkv[:, :, :G * KV], qkv[:, :, G * KV:(G + 1) * KV], qkv[:, :, (G + 1) * KV:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    vf = torch.tensor([64, 0], dtype=torch.int32)
    got = fa.blockwise_attention(q, k, v, window=64, logit_cap=50.0, valid_from=vf)
    want = fa.blockwise_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=64,
                                  logit_cap=50.0, valid_from=vf)
    assert torch.equal(got, want)
    _blockwise_against_the_reference(q.numpy(), k.numpy(), v.numpy(), (64, 0), 64, 50.0, 64,
                                     "float32")


def test_blockwise_attention_without_pads_is_flash_attention():
    """The two wrappers compute one function: the model layout with no
    valid_from equals K7's own layout, causal, bit for bit on the CPU."""
    B, S, H, KV, hd = 2, 50, 4, 2, 8
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    got = fa.blockwise_attention(q, k, v, window=20, logit_cap=50.0)
    want = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              window=20, logit_cap=50.0).transpose(1, 2)
    assert torch.equal(got, want)


def test_valid_from_counts_the_pad_positions():
    """The positions the plain version is given: ``valid_from[b]`` of them
    are -1, the rest ``arange``, as in the reference's ``attn_prefill``."""
    pos = fa.positions_of(torch.tensor([0, 4, 9]), 3, 9)
    assert (pos < 0).sum(-1).tolist() == [0, 4, 9]
    np.testing.assert_array_equal(pos.numpy(), _positions(3, 9, [0, 4, 9]))
    np.testing.assert_array_equal(fa.positions_of(None, 2, 5).numpy(), _positions(2, 5, [0, 0]))


@pytest.mark.parametrize("bad,error,match", [
    ({"q": torch.zeros(1, 3, 16, 8)}, ValueError, "multiple"),
    ({"q": torch.zeros(1, 4, 16, 8, dtype=torch.float64)}, TypeError, "float32 or bfloat16"),
    ({"k": torch.zeros(1, 2, 16, 8, dtype=torch.bfloat16)}, ValueError, "is torch.bfloat16"),
    ({"q": torch.zeros(1, 4, 16, 12), "k": torch.zeros(1, 2, 16, 12),
      "v": torch.zeros(1, 2, 16, 12)}, ValueError, "multiples of 8"),
    ({"q": torch.zeros(1, 4, 8, 16).transpose(2, 3)}, ValueError, "contiguous"),
    ({"v": torch.zeros(1, 2, 15, 8)}, ValueError, "disagree"),
    ({"window": 0}, ValueError, "window"),
    ({"logit_cap": 0.0}, ValueError, "logit_cap"),
], ids=["gqa", "float64", "dtype-mismatch", "hd-12", "hd-strided", "kv-shape", "window-0",
        "cap-0"])
def test_flash_attention_refuses_what_the_kernel_does_not_take(bad, error, match):
    args = {"q": torch.zeros(1, 4, 16, 8), "k": torch.zeros(1, 2, 16, 8),
            "v": torch.zeros(1, 2, 16, 8), "window": None, "logit_cap": None}
    args.update(bad)
    with pytest.raises(error, match=match):
        fa.flash_attention(args["q"], args["k"], args["v"], window=args["window"],
                           logit_cap=args["logit_cap"])


def test_blockwise_attention_takes_self_attention_positions_only():
    """As many keys as queries, and valid_from one integer per row."""
    q, k = torch.zeros(1, 16, 4, 8), torch.zeros(1, 12, 2, 8)
    with pytest.raises(ValueError, match="self-attention"):
        fa.blockwise_attention(q, k, k, window=None, logit_cap=None)
    k = torch.zeros(1, 16, 2, 8)
    for bad in (torch.tensor([0, 1]), torch.tensor([0.0]), [0]):
        with pytest.raises(ValueError, match="valid_from"):
            fa.blockwise_attention(q, k, k, window=None, logit_cap=None, valid_from=bad)


def test_cpu_tensors_launch_nothing():
    kernels.reset_launches()
    q, k = torch.zeros(1, 4, 16, 8), torch.zeros(1, 2, 16, 8)
    fa.flash_attention(q, k, k)
    fa.blockwise_attention(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2),
                           window=None, logit_cap=None, valid_from=torch.tensor([3]))
    assert fa.flash_attention.launches == 0 and fa.blockwise_attention.launches == 0
