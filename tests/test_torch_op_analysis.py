"""The op-level analyzer (``repro_torch.launch.op_analysis``) against
hand-counted programs: the cases of the reference's
``tests/test_hlo_analysis.py`` (one product, products in a loop and in
nested loops, a gradient), recounted for the port, where a Python loop
dispatches its body once per trip; one DTensor product on a fake 16 × 16
mesh, counted once at rank 0's local shapes; collective payloads by kind
(the reference's convention: result bytes, the operand's for a
reduce-scatter); K7's and K7b's fake outputs and flop formulas.

Each fake group (``torch.distributed``'s ``fake`` backend: no process, no
network) is started and destroyed by a fixture, so the gloo tests a worker
runs next start from no group.  Tolerance: equality.
"""

from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.op_analysis import OpAnalysis, analyze


@pytest.fixture
def fake_group():
    """``start(world)`` starts a fake default group of ``world`` ranks (this
    process rank 0); it is destroyed when the test ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_plain_matmul_flops():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    _, t = analyze(torch.matmul, a, b)
    assert t.flops == 2 * 64 * 128 * 32
    assert t.unresolved_whiles == 0
    # operands read, result written: one op, one kernel
    assert t.hbm_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert t.collective_bytes == 0


def test_inference_mode_counts_the_composite_ops_parts():
    """Under ``inference_mode`` ``matmul`` and ``einsum`` reach the mode
    whole; it counts the products they decompose into, as with autograd's
    dispatch."""
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    c = torch.randn(4, 64, 128)

    def fn(a, b, c):
        return torch.matmul(a, b), torch.einsum("bij,jk->bik", c, b)

    _, want = analyze(fn, a, b, c)
    with torch.inference_mode():
        _, got = analyze(fn, a, b, c)
    assert got.flops == want.flops == 2 * 64 * 128 * 32 * (1 + 4)
    assert (got.hbm_bytes, got.n_ops) == (want.hbm_bytes, want.n_ops)


def test_loop_trip_count_scaling():
    """A loop dispatches its body once per trip: 9 trips, 9 products."""
    T = 9
    x, w = torch.randn(16, 32), torch.randn(T, 32, 32)

    def fn(x, w):
        for i in range(T):
            x = torch.tanh(x @ w[i])
        return x

    _, t = analyze(fn, x, w)
    assert t.flops == T * 2 * 16 * 32 * 32
    assert t.unresolved_whiles == 0


def test_nested_loop_scaling():
    T1, T2 = 4, 5
    x, w = torch.randn(8, 16), torch.randn(T1, T2, 16, 16)

    def fn(x, w):
        for i in range(T1):
            for j in range(T2):
                x = torch.tanh(x @ w[i, j])
        return x

    _, t = analyze(fn, x, w)
    assert t.flops == T1 * T2 * 2 * 8 * 16 * 16


def test_grad_flops_at_least_twice_the_forward():
    x = torch.randn(32, 64)
    w = torch.randn(64, 16, requires_grad=True)

    def loss(x, w):
        return torch.tanh(x @ w).sum()

    _, fwd = analyze(loss, x, w)

    def grad(x, w):
        return torch.autograd.grad(loss(x, w), w)

    _, both = analyze(grad, x, w)
    assert fwd.flops == 2 * 32 * 64 * 16
    # the forward again, and dW (dX is not asked for): 2x here, 3x with dX
    assert both.flops - fwd.flops >= fwd.flops
    assert both.flops == 2 * fwd.flops


def test_fake_tensors_count_as_real_ones():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    _, real = analyze(torch.matmul, a, b)
    with FakeTensorMode():
        fa_, fb = torch.empty(64, 128), torch.empty(128, 32)
        _, fake = analyze(torch.matmul, fa_, fb)
    assert (fake.flops, fake.hbm_bytes, fake.n_ops) == (real.flops, real.hbm_bytes, real.n_ops)


def test_products_with_an_out_dtype():
    """``mm`` and ``bmm`` with a float32 output (the card's bf16 products):
    the formula reads the operands' shapes, not the dtype argument."""
    with FakeTensorMode():
        a = torch.empty(4, 8, dtype=torch.bfloat16)
        b = torch.empty(8, 16, dtype=torch.bfloat16)
        _, t = analyze(lambda: torch.mm(a, b, out_dtype=torch.float32))
        _, tb = analyze(lambda: torch.bmm(a[None].expand(3, 4, 8), b[None].expand(3, 8, 16),
                                          out_dtype=torch.float32))
    assert t.flops == 2 * 4 * 8 * 16
    assert tb.flops == 3 * 2 * 4 * 8 * 16


def test_live_memory_peak_of_the_temporaries():
    x = torch.randn(256, 256)

    def fn(x):
        a = x * 2  # 256 KiB
        b = a + 1  # 256 KiB: both alive
        del a
        return b.sum()  # a freed: b and a scalar

    mode = OpAnalysis(memory=True)
    with mode:
        fn(x)
    assert mode.totals.peak_bytes == 2 * 256 * 256 * 4


def test_dtensor_product_counted_once_at_local_shapes(fake_group):
    """On a 16 x 16 mesh a [256, 512] x [512, 8192] product with rows on
    ``data`` and columns on ``model`` is rank 0's [16, 512] x [512, 512]:
    DTensor's dispatch at global shapes and its sharding propagation (on
    global-shape fake tensors) are not counted."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    fake_group(256)
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(16, 512), mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(torch.empty(512, 512), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        out, t = analyze(torch.matmul, a, b)
        assert tuple(out.shape) == (256, 8192)
        assert tuple(out.to_local().shape) == (16, 512)
    assert t.flops == 2 * 16 * 512 * 512
    assert t.flops_by_op == {"mm": 2 * 16 * 512 * 512}
    assert t.collective_bytes == 0


def test_collective_payloads_by_kind(fake_group):
    """8 ranks, an int32 [16, 16] block (1 KiB) a rank: the result's bytes,
    the operand's for a reduce-scatter; c10d and functional collectives."""
    import torch.distributed._functional_collectives as funcol

    fake_group(8)
    x = torch.zeros(16, 16, dtype=torch.int32)
    kb = 16 * 16 * 4

    def c10d():
        recv = torch.empty_like(x)
        dist.all_to_all_single(recv, x)
        out = torch.empty(8 * 16, 16, dtype=torch.int32)
        dist.all_gather_into_tensor(out, x)
        dist.all_reduce(x)
        dist.reduce_scatter_tensor(torch.empty(2, 16, dtype=torch.int32), x)

    with FakeTensorMode():
        x = torch.zeros(16, 16, dtype=torch.int32)
        _, t = analyze(c10d)
        group = dist.group.WORLD
        _, f = analyze(lambda: (funcol.all_gather_tensor(x, 0, group),
                                funcol.all_reduce(x, "sum", group),
                                funcol.reduce_scatter_tensor(x, "sum", 0, group),
                                funcol.all_to_all_single(x, None, None, group)))
    want = {"all-to-all": kb, "all-gather": 8 * kb, "all-reduce": kb, "reduce-scatter": kb}
    assert dict(t.coll_by_kind) == want
    assert dict(t.coll_counts) == dict.fromkeys(want, 1)
    assert t.collective_bytes == 11 * kb
    assert dict(f.coll_by_kind) == want
    assert dict(f.coll_counts) == dict.fromkeys(want, 1)


def test_a_one_rank_group_moves_nothing(fake_group):
    fake_group(1)
    with FakeTensorMode():
        x = torch.zeros(16, 16, dtype=torch.int32)
        _, t = analyze(dist.all_reduce, x)
    assert t.collective_bytes == 0 and not t.coll_counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k7_and_k7b_fake_outputs_and_formulas(dtype):
    """K7 and K7b as custom ops on fake CUDA tensors: no launch, no build,
    outputs of the kernels' shapes and dtypes; K7 4 hd and K7b 10 hd a
    (query, key) pair of B H S T."""
    B, S, H, KV, hd, T = 2, 48, 6, 2, 32, 48
    launches = (fa.blockwise_attention.launches, fa.attention_backward.launches,
                fa.flash_attention.launches)
    with FakeTensorMode():
        q = torch.empty(B, S, H, hd, dtype=dtype, device="cuda")
        k = torch.empty(B, T, KV, hd, dtype=dtype, device="cuda")
        (out, lse), t = analyze(fa._blockwise_forward, q, k, k, None, 50.0, lse=True)
        assert (tuple(out.shape), out.dtype, out.device.type) == ((B, S, H, hd), dtype, "cuda")
        assert (tuple(lse.shape), lse.dtype) == ((B, H, S), torch.float32)
        assert t.flops == 4 * hd * B * H * S * T
        (dq, dk, dv), tb = analyze(fa.attention_backward, q, k, k, out, lse, out, window=16)
        assert [tuple(g.shape) for g in (dq, dk, dv)] == [(B, S, H, hd), (B, T, KV, hd),
                                                          (B, T, KV, hd)]
        assert {g.dtype for g in (dq, dk, dv)} == {dtype}
        assert tb.flops == 10 * hd * B * H * S * T
        # K7 in its own layout, not causal, S != T
        qh = torch.empty(B, H, S, hd, dtype=dtype, device="cuda")
        kh = torch.empty(B, KV, T + 16, hd, dtype=dtype, device="cuda")
        o2, t2 = analyze(fa.flash_attention, qh, kh, kh, causal=False)
        assert (tuple(o2.shape), o2.dtype) == ((B, H, S, hd), dtype)
        assert t2.flops == 4 * hd * B * H * S * (T + 16)
    assert (fa.blockwise_attention.launches, fa.attention_backward.launches,
            fa.flash_attention.launches) == launches
