"""The paper's two-level hash table ``H`` (MRGanter+, Algorithm 6).

Level 1 keys on the *head attribute* of the closure (its smallest member);
level 2 keys on the closure's *length* (popcount).  Leaves are sets of the
packed intent bytes.  This mirrors the paper's reduce-side index used to
"fast index and search a specified closure".

``add_batch`` is the reduce-side bulk insert: keys (head attribute,
popcount, canonical bytes) are computed with batched numpy ops, intra-batch
duplicates collapse through ``np.unique`` on a bytes view, and membership
against the registry is one flat-set probe per *distinct* row — the
per-row ``add`` remains as the paper-literal oracle
(tests/test_torch_host.py holds it against the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset


def batch_heads(rows: np.ndarray) -> np.ndarray:
    """Vectorized ``bitset.head_attr`` for a batch [B, W] → int32 [B].

    Smallest set attribute per row; -1 for empty rows.
    """
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    nonzero = rows != 0
    first_w = np.argmax(nonzero, axis=-1)  # first non-empty word (0 if none)
    v = np.take_along_axis(rows, first_w[:, None], axis=-1)[:, 0]
    lowbit = v & (~v + np.uint32(1))  # isolate lowest set bit
    lsb = np.bitwise_count((lowbit - np.uint32(1)) & np.uint32(0xFFFFFFFF))
    head = first_w * bitset.WORD_BITS + lsb
    return np.where(nonzero.any(axis=-1), head, -1).astype(np.int32)


def batch_heads_torch(rows: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`batch_heads` — same arithmetic on the int32
    view, widened to int64 so the lowest-bit isolation never overflows.
    """
    words = rows.to(torch.int64) & 0xFFFFFFFF
    nonzero = words != 0
    first_w = torch.argmax(nonzero.to(torch.int8), dim=-1)
    v = torch.gather(words, -1, first_w[:, None])[:, 0]
    lowbit = v & -v  # isolate lowest set bit
    shifts = torch.arange(32, device=rows.device)
    lsb = (((lowbit - 1)[:, None] >> shifts) & 1).sum(-1)
    head = first_w * bitset.WORD_BITS + lsb
    return torch.where(nonzero.any(-1), head, -1).to(torch.int32)


def bucket_key(heads, lengths, n_attrs: int):
    """Flat index key combining both hash levels: (head+1)·(m+2) + length.

    Works for numpy and torch inputs alike; strictly increasing in
    (head, length), so a table sorted by it supports two-sided
    ``searchsorted`` bucket probes (the concept store's lookup path).
    """
    return (heads + 1) * (n_attrs + 2) + lengths


class TwoLevelHash:
    def __init__(self):
        self._levels: dict[int, dict[int, set[bytes]]] = {}
        self._keys: set[bytes] = set()  # flat view for O(1) batch probes
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __contains__(self, row: np.ndarray) -> bool:
        head = bitset.head_attr(row)
        length = int(bitset.popcount(row))
        bucket = self._levels.get(head, {}).get(length)
        return bucket is not None and bitset.key_bytes(row) in bucket

    def add(self, row: np.ndarray) -> bool:
        """Insert; returns True iff the intent was new (Alg. 6 line 7)."""
        head = bitset.head_attr(row)
        length = int(bitset.popcount(row))
        bucket = self._levels.setdefault(head, {}).setdefault(length, set())
        key = bitset.key_bytes(row)
        if key in bucket:
            return False
        bucket.add(key)
        self._keys.add(key)
        self._n += 1
        return True

    def add_batch(self, rows: np.ndarray) -> list[int]:
        """Insert a batch [B, W]; returns indices of the rows that were new.

        Semantics match a row-by-row ``add`` loop: the *first* occurrence
        of each previously-unseen intent is reported, in ascending batch
        order.
        """
        B = rows.shape[0]
        if B == 0:
            return []
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        # Intra-batch dedupe on the raw bytes; first-occurrence indices.
        view = rows.view([("", np.uint8)] * rows.dtype.itemsize * rows.shape[1])
        _, first_idx = np.unique(view, return_index=True)
        first_idx = np.sort(first_idx)
        cand = rows[first_idx]
        heads = batch_heads(cand)
        lengths = bitset.popcount(cand)
        out: list[int] = []
        for i, head, length in zip(first_idx, heads, lengths):
            key = rows[i].tobytes()
            if key in self._keys:
                continue
            self._keys.add(key)
            self._levels.setdefault(int(head), {}).setdefault(
                int(length), set()
            ).add(key)
            out.append(int(i))
            self._n += 1
        return out

    def bucket_stats(self) -> dict[str, float]:
        sizes = [
            len(s) for lv2 in self._levels.values() for s in lv2.values()
        ]
        if not sizes:
            return {"buckets": 0, "max": 0, "mean": 0.0}
        return {
            "buckets": len(sizes),
            "max": max(sizes),
            "mean": float(np.mean(sizes)),
        }
