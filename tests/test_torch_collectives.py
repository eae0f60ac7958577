"""The port's AND-allreduce schedules and wire-cost model against the JAX
package's ``repro.dist.collectives``.

The simulated axis is held against the reference's ``and_allreduce`` under
a named ``jax.vmap`` (which needs the jax-0.9 binding of the
``jax_reference`` fixture); a 4-rank gloo process group on the CPU is held
against the simulated axis.  Tolerance: exact equality of every word.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as rcoll
from repro_torch import device as dev
from repro_torch.dist import collectives as coll

from _torch_reference import jax_reference, random_bits, t, u32  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

RANK_PRELUDE = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
"""


def run_ranks(tmp_path, body: str, world: int = 4, timeout: float = 240) -> list:
    """Run ``body`` in ``world`` fresh processes joined by a gloo group on
    the CPU; each prints one JSON value as its last line, returned in rank
    order.  The group meets through a file under ``tmp_path`` (no TCP
    port, so parallel test workers cannot collide), and every process is
    killed if the ranks have not all finished within ``timeout`` seconds,
    so a hang fails the test instead of stalling the run."""
    code = RANK_PRELUDE + body + "\ndist.destroy_process_group()\n"
    init = f"file://{tmp_path}/pg"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(r), str(world), init],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, cwd=tmp_path)
        for r in range(world)
    ]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, f"rank {r} failed:\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _reference_sim(x: np.ndarray, impl: str, n_attrs) -> np.ndarray:
    """The reference's and_allreduce on a named vmap axis: [k, B, W]."""
    f = jax.vmap(
        lambda v: rcoll.and_allreduce(v, "objpart", impl=impl, n_attrs=n_attrs),
        axis_name="objpart",
    )
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("n_attrs", [None, 45])
@pytest.mark.parametrize("B", [5, 16])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("impl", list(coll.IMPLS))
def test_and_allreduce_matches_reference_on_the_simulated_axis(
    jax_reference, impl, k, B, n_attrs  # noqa: F811
):
    rng = np.random.default_rng(1000 * k + B)
    W = 2
    x = random_bits(rng, k * B, W, 0.9).reshape(k, B, W)
    x[:, :, 0] |= np.uint32(1 << 31)  # bit 31 set in every block
    x[0, 0, 0] &= np.uint32(0x7FFFFFFF)  # and cleared in one of them
    if n_attrs is not None:  # pmin drops lanes past n_attrs: mask them out
        x &= np.asarray([0xFFFFFFFF, (1 << (n_attrs - 32)) - 1], np.uint32)
    want = _reference_sim(x, impl, n_attrs)
    got = coll.and_allreduce(t(x.reshape(k * B, W)).reshape(k, B, W), coll.SIM_AXIS,
                             impl=impl, n_attrs=n_attrs)
    assert tuple(got.shape) == (k, B, W)
    np.testing.assert_array_equal(u32(got.contiguous()), want.astype(np.uint32))
    np.testing.assert_array_equal(u32(got[0]), np.bitwise_and.reduce(x, axis=0))


def test_sum_allreduce_on_the_simulated_axis():
    x = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    got = coll.sum_allreduce(x, coll.SIM_AXIS)
    assert got.shape == (4, 6) and torch.equal(got[2], x.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("m", [1, 31, 32, 33, 96])
def test_lanes_round_trip_with_bit_31(m):
    rng = np.random.default_rng(m)
    x = random_bits(rng, 7, 3, 0.5)
    x[:, 0] |= np.uint32(1 << 31)
    lanes = dev.unpack_lanes(t(x), m)
    ref_lanes = ((x[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(7, 96)[:, :m]
    np.testing.assert_array_equal(lanes.numpy(), ref_lanes)
    masked = (ref_lanes.astype(np.uint64) << np.arange(m, dtype=np.uint64) % 32)
    want = np.zeros((7, 3), np.uint64)
    for lane in range(m):
        want[:, lane // 32] |= masked[:, lane]
    np.testing.assert_array_equal(u32(dev.pack_lanes(lanes, 3)), want.astype(np.uint32))


def test_bad_schedule_or_axis_raises():
    x = torch.zeros((2, 8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown reduce impl"):
        coll.and_allreduce(x, coll.SIM_AXIS, impl="ring")
    with pytest.raises(ValueError, match="unknown reduce axis"):
        coll.and_allreduce(x, "data", impl="rsag")


@pytest.mark.parametrize("impl", list(coll.IMPLS))
def test_cost_model_matches_reference(impl):
    for k in (1, 2, 3, 4, 8, 16):
        assert coll.ring_steps(impl, k) == rcoll.ring_steps(impl, k)
        for batch in (1, 8, 100, 8192):
            for W, n_attrs in ((1, None), (4, 125), (5, 133)):
                assert coll.modeled_comm_bytes(impl, k, batch, W, n_attrs) == \
                    rcoll.modeled_comm_bytes(impl, k, batch, W, n_attrs)
                for hop in (1, 4096, 70_000):
                    assert coll.modeled_cost_bytes(impl, k, batch, W, n_attrs, hop_bytes=hop) \
                        == rcoll.modeled_cost_bytes(impl, k, batch, W, n_attrs, hop_bytes=hop)
    with pytest.raises(ValueError):
        coll.modeled_comm_bytes("ring", 2, 8, 1)
    with pytest.raises(ValueError):
        coll.ring_steps("ring", 2)


GROUP_BODY = """
from repro_torch.dist import collectives as coll

k, B, W = world, 13, 3
rng = np.random.default_rng(7)
x = rng.integers(0, 2**32, size=(k, B, W), dtype=np.uint64).astype(np.uint32)
x |= rng.integers(0, 2**32, size=(k, B, W), dtype=np.uint64).astype(np.uint32)
local = torch.from_numpy(x[rank].view(np.int32).copy())
out = {}
for impl in coll.IMPLS:
    for n_attrs in (None, 96):
        r = coll.and_allreduce(local, dist.group.WORLD, impl=impl, n_attrs=n_attrs)
        out[f"{impl}/{n_attrs}"] = r.numpy().view(np.uint32).tolist()
s = coll.sum_allreduce(torch.arange(B, dtype=torch.int32) * (rank + 1), dist.group.WORLD)
out["sum"] = s.tolist()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def group_results(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("pg"), GROUP_BODY, world=4)


@pytest.mark.parametrize("n_attrs", [None, 96])
@pytest.mark.parametrize("impl", list(coll.IMPLS))
def test_and_allreduce_over_a_gloo_group_matches_the_simulated_axis(group_results, impl,
                                                                    n_attrs):
    k, B, W = 4, 13, 3
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, size=(k, B, W), dtype=np.uint64).astype(np.uint32)
    x |= rng.integers(0, 2**32, size=(k, B, W), dtype=np.uint64).astype(np.uint32)
    sim = coll.and_allreduce(t(x.reshape(k * B, W)).reshape(k, B, W), coll.SIM_AXIS,
                             impl=impl, n_attrs=n_attrs)
    want = u32(sim[0]).tolist()
    for rank, out in enumerate(group_results):
        assert out[f"{impl}/{n_attrs}"] == want, f"rank {rank}"
    assert all(out["sum"] == [10 * b for b in range(B)] for out in group_results)
