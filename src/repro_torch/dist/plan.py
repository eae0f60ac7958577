"""The one-object-shard plan, and the reduce phase's analytic cost model.

The reference runs every round through a ``ShardPlan`` (object shards on
a mesh or simulated on one device, one AND-allreduce per round).  This
slice of the port runs one object shard, where the AND-allreduce is the
identity and moves nothing; the plan keeps the geometry the engine needs
(``block_n`` row alignment, the ``max_batch`` candidate chunk cap) and
the wire-byte census, which charges 0 bytes at k = 1 exactly as the
reference does.  Plans with ``n_parts > 1`` raise: they come with the
multi-shard slice.

The cost functions (``modeled_comm_bytes``, ``ring_steps``,
``modeled_cost_bytes``) are pure-Python copies of the reference's
``dist/collectives.py`` ones, so the census stays comparable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import device_bits

IMPLS = ("allgather", "rsag", "pmin")
AUTO_IMPLS = ("allgather", "rsag")


def modeled_comm_bytes(
    impl: str, n_parts: int, batch: int, W: int, n_attrs: int | None = None
) -> int:
    """Analytic wire bytes for one reduce round over all ``n_parts`` shards."""
    if n_parts <= 1:
        return 0
    word_bytes = batch * W * 4
    if impl == "allgather":
        return n_parts * (n_parts - 1) * word_bytes
    if impl == "rsag":
        return int(2 * (n_parts - 1) * word_bytes)  # ring RS + AG, summed
    if impl == "pmin":
        lanes = n_attrs if n_attrs is not None else W * 32
        return n_parts * (n_parts - 1) * batch * lanes * 4
    raise ValueError(f"unknown reduce impl {impl!r}; choose {IMPLS}")


def ring_steps(impl: str, n_parts: int) -> int:
    """Per-device ring-step (latency hop) count for one reduce round."""
    if impl not in IMPLS:
        raise ValueError(f"unknown reduce impl {impl!r}; choose {IMPLS}")
    if n_parts <= 1:
        return 0
    k = n_parts
    return 2 * (k - 1) if impl == "rsag" else k - 1


def modeled_cost_bytes(
    impl: str,
    n_parts: int,
    batch: int,
    W: int,
    n_attrs: int | None = None,
    *,
    hop_bytes: int = 4096,
) -> int:
    """α-β reduce-cost model in byte units: wire volume + per-hop latency."""
    if n_parts <= 1:
        return 0
    return modeled_comm_bytes(impl, n_parts, batch, W, n_attrs) + (
        n_parts * ring_steps(impl, n_parts) * hop_bytes
    )


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Partition geometry and the reduce schedule for one run."""

    n_parts: int = 1
    reduce_impl: str = "rsag"
    block_n: int = 256
    max_batch: int = 8192
    auto_hop_bytes: int = 4096
    hop_calibrated: bool = False

    def __post_init__(self):
        if self.reduce_impl != "auto" and self.reduce_impl not in IMPLS:
            raise ValueError(
                f"unknown reduce schedule {self.reduce_impl!r}; "
                f"choose {IMPLS + ('auto',)}"
            )
        if self.n_parts != 1:
            raise NotImplementedError(
                f"n_parts={self.n_parts}: this slice of the port runs one "
                "object shard; multi-shard plans come with the next slice"
            )
        if self.block_n < 1 or self.max_batch < 1:
            raise ValueError("block_n and max_batch must be >= 1")

    @property
    def row_alignment(self) -> int:
        """Context rows pad to a multiple of this (shards block-align)."""
        return self.n_parts * self.block_n

    def place_rows(self, rows: np.ndarray, device) -> torch.Tensor:
        """Padded context rows ``[N, W]`` (uint32) on ``device`` as int32."""
        if rows.shape[0] % self.row_alignment:
            raise ValueError(
                f"rows ({rows.shape[0]}) not aligned to {self.row_alignment}"
            )
        return device_bits(rows, device)

    def resolve_impl(self, batch: int, W: int, n_attrs: int | None = None) -> str:
        """The schedule one reduce round of ``batch`` candidates runs."""
        if self.reduce_impl != "auto":
            return self.reduce_impl
        return min(
            AUTO_IMPLS,
            key=lambda impl: modeled_cost_bytes(
                impl, self.n_parts, batch, W, n_attrs,
                hop_bytes=self.auto_hop_bytes,
            ),
        )

    def modeled_latency_split(
        self, batch: int, W: int, n_attrs: int | None = None
    ) -> tuple[int, int]:
        """``(dispatch_bytes, collective_bytes)`` — the α-β split of one
        reduce round's modeled cost (both 0 on one shard)."""
        impl = self.resolve_impl(batch, W, n_attrs)
        vol = modeled_comm_bytes(impl, self.n_parts, batch, W, n_attrs)
        hops = self.n_parts * ring_steps(impl, self.n_parts) * self.auto_hop_bytes
        return hops, vol

    def describe(self) -> dict:
        """JSON-friendly summary for launcher output."""
        return {
            "mode": "single",
            "n_parts": self.n_parts,
            "reduce_impl": self.reduce_impl,
            "block_n": self.block_n,
            "max_batch": self.max_batch,
            "auto_hop_bytes": self.auto_hop_bytes,
            "hop_calibrated": self.hop_calibrated,
        }
