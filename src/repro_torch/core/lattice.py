"""Concept lattice construction from a mined intent set — a numpy copy of
the reference's ``core/lattice.py``.

FCA's main theorem guarantees the complete set of intents forms a lattice
under set inclusion; this module materializes the covering relation (Hasse
diagram) used by the examples, the paper-example tests (Table 2) and the
query subsystem (:mod:`repro_torch.query.store`).

Two interchangeable covering builders:
  * ``matmul`` (default) — the subset relation as one popcount matmul over
    unpacked bit-planes (``|y_i ∩ y_j| == |y_i|``), and the transitive
    reduction as a second boolean matmul (``strict & ~(strict ∘ strict)``).
    O(C²·m + C³) BLAS work instead of O(C²) interpreted Python; the same
    arithmetic runs device-side in the concept store.
  * ``host`` — the original per-pair Python loop, kept as the equivalence
    oracle (the reference's tests property-test the two against each other
    and against a brute-force transitive-reduction oracle; the port's hold
    the store's order tables against ``covering_matmul``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import bitset, closure
from repro_torch.core.context import FormalContext

METHODS = ("matmul", "host")


@dataclasses.dataclass
class ConceptLattice:
    intents: np.ndarray  # [C, W] uint32, sorted by popcount ascending
    extents: np.ndarray  # [C, N] bool
    children: list[list[int]]  # covering relation: i covers j (j's intent ⊂ i's)

    @property
    def n_concepts(self) -> int:
        return self.intents.shape[0]

    def top(self) -> int:
        """Index of ⟨O, ∅''⟩ — the concept with the smallest intent."""
        return 0

    def bottom(self) -> int:
        return self.n_concepts - 1


def subset_matrix(intents: np.ndarray, n_attrs: int) -> np.ndarray:
    """``leq[i, j] = intent_i ⊆ intent_j`` for packed intents [C, W].

    One popcount matmul over the unpacked {0,1} bit-planes: with
    ``B = bits(intents)``, ``(B @ B.T)[i, j] = |y_i ∩ y_j|``, and
    ``y_i ⊆ y_j ⟺ |y_i ∩ y_j| == |y_i|``.  fp32 accumulation is exact
    (counts ≤ m ≪ 2²⁴).
    """
    bits = bitset.unpack_bits(intents, n_attrs).astype(np.float32)
    inter = bits @ bits.T  # [C, C] — |y_i ∩ y_j|
    sizes = bits.sum(axis=1)
    return inter == sizes[:, None]


def covering_matmul(leq: np.ndarray) -> np.ndarray:
    """Transitive reduction of a strict containment order as a matmul.

    ``strict[i, j] = y_i ⊂ y_j``; ``i`` is covered by ``j`` iff no ``k``
    lies strictly between, i.e. ``(strict ∘ strict)[i, j] == 0``.
    """
    strict = leq & ~np.eye(leq.shape[0], dtype=bool)
    s = strict.astype(np.float32)
    via = (s @ s) > 0  # [i, j]: ∃k with i ⊂ k ⊂ j
    return strict & ~via


def build_lattice(
    ctx: FormalContext, intents: list[np.ndarray], *, method: str = "matmul"
) -> ConceptLattice:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose {METHODS}")
    arr = np.stack(intents)
    sizes = bitset.popcount(arr)
    order = np.argsort(sizes, kind="stable")
    arr = arr[order]
    sizes = sizes[order]
    extents = np.stack([closure.extent_np(ctx.rows, y) for y in arr])

    C = arr.shape[0]
    if method == "matmul":
        cover = covering_matmul(subset_matrix(arr, ctx.n_attrs))
        children = [list(np.nonzero(cover[:, i])[0]) for i in range(C)]
        return ConceptLattice(intents=arr, extents=extents, children=children)

    children = [[] for _ in range(C)]
    # i covers j  ⟺  intent[j] ⊂ intent[i] and no k with j ⊂ k ⊂ i.
    for i in range(C):
        subs = [
            j
            for j in range(i)
            if sizes[j] < sizes[i] and bool(bitset.is_subset(arr[j], arr[i]))
        ]
        sub_set = set(subs)
        for j in subs:
            if not any(
                k in sub_set and bool(bitset.is_subset(arr[j], arr[k])) and k != j
                for k in subs
                if sizes[k] > sizes[j]
            ):
                children[i].append(j)
    return ConceptLattice(intents=arr, extents=extents, children=children)
