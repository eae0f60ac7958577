"""Packed-bitset utilities for formal contexts.

Attribute sets over ``m`` attributes are packed little-endian into
``W = ceil(m/32)`` uint32 words: attribute ``a`` lives in word ``a // 32``,
bit ``a % 32``.  The same layout is used host-side (numpy, uint32) and
device-side (torch, the same 32 bits viewed as int32); these helpers are
the host-side/numpy half, ``repro_torch.core.closure`` holds the torch half.

Lectic order convention: attribute index 0 is the *smallest* attribute
(the paper's ``p_1``), so "bits below a" == ``low_mask(a)``.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32
_FULL = np.uint32(0xFFFFFFFF)


def n_words(n_attrs: int) -> int:
    """Number of uint32 words needed for ``n_attrs`` attributes."""
    return max(1, (n_attrs + WORD_BITS - 1) // WORD_BITS)


def attr_mask(n_attrs: int, W: int | None = None) -> np.ndarray:
    """``[W]`` uint32 mask with exactly the first ``n_attrs`` bits set."""
    W = n_words(n_attrs) if W is None else W
    mask = np.zeros(W, dtype=np.uint32)
    full_words = n_attrs // WORD_BITS
    mask[:full_words] = _FULL
    rem = n_attrs % WORD_BITS
    if rem and full_words < W:
        mask[full_words] = np.uint32((1 << rem) - 1)
    return mask


def low_mask(a: int, W: int) -> np.ndarray:
    """``[W]`` mask of all attribute bits strictly below ``a``."""
    return attr_mask(a, W)


def bit(a: int, W: int) -> np.ndarray:
    """``[W]`` mask with only attribute ``a`` set."""
    out = np.zeros(W, dtype=np.uint32)
    out[a // WORD_BITS] = np.uint32(1 << (a % WORD_BITS))
    return out


def pack_bool(dense: np.ndarray, W: int | None = None) -> np.ndarray:
    """Pack a bool array ``[..., m]`` into ``[..., W]`` uint32 words."""
    dense = np.asarray(dense, dtype=bool)
    m = dense.shape[-1]
    W = n_words(m) if W is None else W
    pad = W * WORD_BITS - m
    if pad:
        dense = np.concatenate(
            [dense, np.zeros(dense.shape[:-1] + (pad,), dtype=bool)], axis=-1
        )
    b = dense.reshape(dense.shape[:-1] + (W, WORD_BITS))
    weights = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32)).astype(np.uint32)
    return (b.astype(np.uint32) * weights).sum(axis=-1, dtype=np.uint32)


def unpack_bits(packed: np.ndarray, n_attrs: int) -> np.ndarray:
    """Unpack ``[..., W]`` uint32 words into a bool array ``[..., n_attrs]``."""
    packed = np.asarray(packed, dtype=np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (packed[..., :, None] >> shifts) & np.uint32(1)
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * WORD_BITS,))
    return flat[..., :n_attrs].astype(bool)


def popcount(packed: np.ndarray) -> np.ndarray:
    """Per-set popcount of ``[..., W]`` packed sets → ``[...]`` int64."""
    return np.bitwise_count(np.asarray(packed, dtype=np.uint32)).sum(axis=-1).astype(np.int64)


def to_indices(row: np.ndarray) -> list[int]:
    """Attribute indices present in a single packed set ``[W]``."""
    return [int(i) for i in np.nonzero(unpack_bits(row, row.shape[-1] * WORD_BITS))[0]]


def from_indices(indices, n_attrs: int, W: int | None = None) -> np.ndarray:
    """Packed set ``[W]`` from an iterable of attribute indices."""
    W = n_words(n_attrs) if W is None else W
    out = np.zeros(W, dtype=np.uint32)
    for a in indices:
        if not 0 <= a < n_attrs:
            raise ValueError(f"attribute index {a} out of range [0,{n_attrs})")
        out[a // WORD_BITS] |= np.uint32(1 << (a % WORD_BITS))
    return out


def head_attr(row: np.ndarray) -> int:
    """Index of the smallest attribute in a packed set, or -1 if empty.

    This is the first-level key of the paper's two-level hash table.
    """
    row = np.asarray(row, dtype=np.uint32)
    for w in range(row.shape[-1]):
        v = int(row[w])
        if v:
            return w * WORD_BITS + (v & -v).bit_length() - 1
    return -1


def is_subset(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise (over leading dims) test ``a ⊆ b`` for packed sets."""
    return np.all((np.asarray(a) & ~np.asarray(b)) == 0, axis=-1)


def key_bytes(row: np.ndarray) -> bytes:
    """Canonical dict key for a packed set."""
    return np.ascontiguousarray(row, dtype=np.uint32).tobytes()
