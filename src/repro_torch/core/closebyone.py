"""CloseByOne (Kuznetsov), centralized — the paper's comparison baseline.

Implemented breadth-first by levels so that "iterations" means the same
thing as for MRCbo (one MapReduce round per level, Table 9: 14 / 11 / 11).
Each level expands every intent found in the previous level with every
attribute above its generator; the canonicity test

    Z ∩ {bits < a}  ==  Y ∩ {bits < a}

guarantees each concept is produced exactly once, so no global dedupe is
needed (that is CbO's defining trick vs MRGanter+'s hash table).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import bitset, closure, lectic
from repro_torch.core.context import FormalContext
from repro_torch.core.nextclosure import first_closure


@dataclasses.dataclass
class CbOResult:
    intents: list[np.ndarray]
    n_iterations: int
    n_closures_computed: int


def close_by_one(ctx: FormalContext, max_level_batch: int = 1 << 16) -> CbOResult:
    tables = lectic.LecticTables(ctx.n_attrs)
    mask = ctx.attr_mask()
    root = first_closure(ctx)
    intents: list[np.ndarray] = [root]
    # Frontier entries: (intent, generator attribute) — expand with a' > a.
    frontier: list[tuple[np.ndarray, int]] = [(root, -1)]
    n_iter = 0
    n_closures = 0

    while frontier:
        n_iter += 1
        seeds = []
        parents = []
        gens = []
        for Y, g in frontier:
            member = bitset.unpack_bits(Y, ctx.n_attrs)
            for a in range(g + 1, ctx.n_attrs):
                if member[a]:
                    continue
                seeds.append(Y | tables.BIT[a])
                parents.append(Y)
                gens.append(a)
        if not seeds:
            break
        next_frontier: list[tuple[np.ndarray, int]] = []
        for lo in range(0, len(seeds), max_level_batch):
            batch = np.stack(seeds[lo : lo + max_level_batch])
            cands, _ = closure.batched_closure_np(ctx.rows, batch, mask)
            n_closures += batch.shape[0]
            for i in range(batch.shape[0]):
                a = gens[lo + i]
                Y = parents[lo + i]
                Z = cands[i]
                # Canonicity: no new attribute below the generator.
                if np.all(((Z ^ Y) & tables.LOW[a]) == 0):
                    intents.append(Z)
                    next_frontier.append((Z, a))
        frontier = next_frontier

    return CbOResult(intents=intents, n_iterations=n_iter, n_closures_computed=n_closures)
