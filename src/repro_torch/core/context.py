"""Formal contexts ``(O, P, I)`` as packed bitset matrices.

The context is the MapReduce *static data*: in the distributed algorithms it
stays device-resident for the whole run — the analogue of Twister caching
static data on long-running map tasks.  This slice of the port runs one
object shard; ``partition`` is the host-side split later slices shard by.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import bitset


@dataclasses.dataclass(frozen=True)
class FormalContext:
    """A formal context with rows packed into uint32 bitset words.

    Attributes:
      rows:     ``[n_objects, W]`` uint32 — object -> packed attribute set.
      n_objects: number of (real) objects.
      n_attrs:   number of attributes ``m``; ``W = ceil(m/32)``.
      attr_names / obj_names: optional labels (paper's Table 1 uses a..g, 1..6).
    """

    rows: np.ndarray
    n_objects: int
    n_attrs: int
    attr_names: tuple[str, ...] | None = None
    obj_names: tuple[str, ...] | None = None

    def __post_init__(self):
        rows = np.ascontiguousarray(self.rows, dtype=np.uint32)
        if rows.ndim != 2 or rows.shape[0] != self.n_objects:
            raise ValueError(f"rows shape {rows.shape} != ({self.n_objects}, W)")
        if rows.shape[1] != bitset.n_words(self.n_attrs):
            raise ValueError(
                f"W={rows.shape[1]} != n_words({self.n_attrs})="
                f"{bitset.n_words(self.n_attrs)}"
            )
        # Defensive: no stray bits above n_attrs.
        mask = bitset.attr_mask(self.n_attrs, rows.shape[1])
        if np.any(rows & ~mask):
            raise ValueError("context rows contain bits above n_attrs")
        object.__setattr__(self, "rows", rows)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_dense(
        cls,
        dense: np.ndarray,
        attr_names: Sequence[str] | None = None,
        obj_names: Sequence[str] | None = None,
    ) -> "FormalContext":
        dense = np.asarray(dense, dtype=bool)
        if dense.ndim != 2:
            raise ValueError("dense context must be 2-D [objects, attributes]")
        return cls(
            rows=bitset.pack_bool(dense),
            n_objects=dense.shape[0],
            n_attrs=dense.shape[1],
            attr_names=tuple(attr_names) if attr_names is not None else None,
            obj_names=tuple(obj_names) if obj_names is not None else None,
        )

    @classmethod
    def synthetic(
        cls, n_objects: int, n_attrs: int, density: float, seed: int = 0
    ) -> "FormalContext":
        """IID Bernoulli context matching a target density (paper Table 7)."""
        rng = np.random.default_rng(seed)
        dense = rng.random((n_objects, n_attrs)) < density
        return cls.from_dense(dense)

    # -- views -------------------------------------------------------------

    @property
    def W(self) -> int:
        return self.rows.shape[1]

    @property
    def density(self) -> float:
        total = self.n_objects * self.n_attrs
        return float(bitset.popcount(self.rows).sum()) / total if total else 0.0

    def attr_mask(self) -> np.ndarray:
        return bitset.attr_mask(self.n_attrs, self.W)

    def dense(self) -> np.ndarray:
        return bitset.unpack_bits(self.rows, self.n_attrs)

    # -- partitioning (paper §3: disjoint object partitions S_1..S_n) -------

    def partition(self, n_parts: int, shuffle: bool = False, seed: int = 0):
        """Split objects into ``n_parts`` disjoint partitions.

        ``shuffle=True`` implements the paper's suggested improvement of
        equalizing partition density by randomizing object placement.
        Returns a list of FormalContext; their union (in order) is ``self``
        up to the permutation.
        """
        if n_parts < 1:
            raise ValueError("n_parts must be >= 1")
        order = np.arange(self.n_objects)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        splits = np.array_split(order, n_parts)
        return [
            FormalContext(
                rows=self.rows[idx],
                n_objects=len(idx),
                n_attrs=self.n_attrs,
                attr_names=self.attr_names,
            )
            for idx in splits
        ]

    def padded_rows(self, multiple: int) -> tuple[np.ndarray, int]:
        """Rows padded up to a multiple with all-ones rows.

        All-ones padding rows are the AND-identity and match every candidate;
        the closure kernel corrects supports by the pad count (see
        ``repro_torch.kernels.ops``).  Returns ``(rows, n_pad)``.
        """
        n = self.n_objects
        n_padded = ((n + multiple - 1) // multiple) * multiple
        if n_padded == n:
            return self.rows, 0
        pad = np.full((n_padded - n, self.W), 0xFFFFFFFF, dtype=np.uint32)
        return np.concatenate([self.rows, pad], axis=0), n_padded - n


def paper_context() -> FormalContext:
    """The worked example from the paper's Table 1 (6 objects, a..g)."""
    table = [
        "ab.d.f.",  # 1
        "a.c.e.g",  # 2
        ".bcd.fg",  # 3
        ".b.de..",  # 4
        "a..def.",  # 5
        ".bc..fg",  # 6
    ]
    dense = np.array([[c != "." for c in row] for row in table], dtype=bool)
    return FormalContext.from_dense(
        dense,
        attr_names=tuple("abcdefg"),
        obj_names=tuple("123456"),
    )
