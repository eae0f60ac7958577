"""Lectic order machinery: the ⊕-operator and the ≤_{p_i} feasibility test.

Convention: attribute index 0 == the paper's smallest attribute ``p_1``.
For packed sets, "the bits strictly below attribute ``a``" is
``bitset.low_mask(a)``; the NextClosure feasibility condition

    Y ⊕ p_i  is accepted  ⟺  (Y ⊕ p_i) ∩ {p_1..p_{i-1}}  ==  Y ∩ {p_1..p_{i-1}}

becomes the word-parallel test ``((cand ^ Y) & low_mask(a)) == 0``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset


class LecticTables:
    """Precomputed per-attribute masks: LOW[a] = bits<a, BIT[a] = {a}."""

    def __init__(self, n_attrs: int):
        W = bitset.n_words(n_attrs)
        self.n_attrs = n_attrs
        self.W = W
        self.LOW = np.stack([bitset.low_mask(a, W) for a in range(n_attrs)])
        self.BIT = np.stack([bitset.bit(a, W) for a in range(n_attrs)])
        self.attr_mask = bitset.attr_mask(n_attrs, W)


def oplus_seed(Y: np.ndarray, a: int, tables: LecticTables) -> np.ndarray:
    """The pre-closure seed of ``Y ⊕ p_a``: ``(Y ∩ {bits<a}) ∪ {a}``."""
    return (Y & tables.LOW[a]) | tables.BIT[a]


def oplus_seeds_all(Y: np.ndarray, tables: LecticTables) -> tuple[np.ndarray, np.ndarray]:
    """Seeds for every attribute ``a ∉ Y`` at once.

    Returns (seeds [m, W], valid [m] bool) — ``valid[a]`` is False when
    ``a ∈ Y`` (no candidate is generated for members, Alg. 4 line 2).
    """
    seeds = (Y[None, :] & tables.LOW) | tables.BIT  # [m, W]
    member = bitset.unpack_bits(Y, tables.n_attrs)  # [m]
    return seeds, ~member


def feasible(cand: np.ndarray, Y: np.ndarray, a: int, tables: LecticTables) -> bool:
    """NextClosure acceptance: ``cand`` ≤_{p_a}-succeeds ``Y`` (Eqn. 4)."""
    return bool(np.all(((cand ^ Y) & tables.LOW[a]) == 0))


def feasible_batch(
    cands: np.ndarray, Y: np.ndarray, tables: LecticTables
) -> np.ndarray:
    """Vectorized acceptance for the candidate-per-attribute batch [m, W]."""
    return np.all(((cands ^ Y[None, :]) & tables.LOW) == 0, axis=-1)


def lectic_leq(y1: np.ndarray, y2: np.ndarray, n_attrs: int) -> bool:
    """Total lectic order test ``y1 < y2`` (Eqn. 3); False if equal.

    y1 < y2 iff the smallest attribute where they differ is in y2.
    """
    diff = y1 ^ y2
    if not np.any(diff):
        return False
    a = bitset.head_attr(diff)
    return bool(bitset.unpack_bits(y2, n_attrs)[a])


# ---------------------------------------------------------------------------
# torch twins — the device half used by the frontier pipeline (core.frontier).
# Same arithmetic as the numpy ops above, on [batch, ...] int32 views of the
# packed words.
# ---------------------------------------------------------------------------


def member_bits_torch(Y: torch.Tensor, n_attrs: int) -> torch.Tensor:
    """Unpack ``[..., W]`` packed sets to bool ``[..., n_attrs]`` on device.

    Arithmetic right shifts of the int32 view still leave bit ``s`` in
    bit 0, so ``(Y >> s) & 1`` is the unsigned bit for every ``s``."""
    shifts = torch.arange(32, dtype=torch.int32, device=Y.device)
    bits = (Y[..., :, None] >> shifts) & 1
    flat = bits.reshape(*Y.shape[:-1], Y.shape[-1] * 32)
    return flat[..., :n_attrs].bool()


def oplus_seeds_torch(
    Y: torch.Tensor, LOW: torch.Tensor, BIT: torch.Tensor, n_attrs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ⊕-seeds for a frontier ``Y [F, W]``.

    Returns ``(seeds [F, m, W], valid [F, m])`` — the device twin of
    ``oplus_seeds_all`` over the whole frontier at once.
    """
    seeds = (Y[:, None, :] & LOW[None, :, :]) | BIT[None, :, :]
    valid = ~member_bits_torch(Y, n_attrs)
    return seeds, valid


def cbo_seeds_torch(
    Y: torch.Tensor, gens: torch.Tensor, BIT: torch.Tensor, n_attrs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched CbO expansion seeds ``Y ∪ {a}`` for ``a > gen, a ∉ Y``.

    Y [F, W] packed frontier intents, gens [F] generator attrs.
    Returns ``(seeds [F, m, W], valid [F, m])``.
    """
    seeds = Y[:, None, :] | BIT[None, :, :]
    attrs = torch.arange(n_attrs, dtype=gens.dtype, device=gens.device)
    valid = ~member_bits_torch(Y, n_attrs) & (attrs[None, :] > gens[:, None])
    return seeds, valid


def feasible_torch(
    closures: torch.Tensor, parents: torch.Tensor, gens: torch.Tensor,
    LOW: torch.Tensor,
) -> torch.Tensor:
    """Word-parallel ``((Z ^ Y) & LOW[a]) == 0`` for a batch ``[B, ...]``.

    This single test is both NextClosure's ≤_{p_i} feasibility (Eqn. 4) and
    CbO's canonicity check — the two drivers differ only in which parent/
    generator pairs they feed it.
    """
    return (((closures ^ parents) & LOW[gens.long()]) == 0).all(-1)


def select_lectic(
    closures: torch.Tensor, ok: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick the lectic-max feasible candidate on device (Alg. 5 line 6).

    ``closures [B, W]`` is the per-attribute candidate batch in ascending
    generator order, ``ok [B]`` the feasibility mask; NextClosure takes the
    *largest* feasible generator.  The order is over generator indices,
    not over the words, so no unsigned key is needed: an argmax over
    ``where(ok, arange, -1)`` (first maximum on ties, as in the reference)
    plus a gather, so the selection never forces a readback (the gather is
    ``index_select``: indexing with a 0-dim tensor would read it on the
    host).  Returns ``(Y_next [W], found [] bool)``; ``Y_next`` is
    ``closures[0]`` garbage when nothing is feasible — gate on ``found``.
    """
    idx_all = torch.arange(ok.shape[0], dtype=torch.int32, device=ok.device)
    score = torch.where(ok, idx_all, -1)
    idx = torch.argmax(score).reshape(1)
    return closures.index_select(0, idx)[0], score.index_select(0, idx)[0] >= 0


def lectic_sort_key(row: np.ndarray, n_attrs: int) -> tuple:
    """Sort key producing ascending lectic order for packed sets.

    In lectic order, comparing the bit-reversed attribute vector as an
    integer works: smaller attributes are more significant, and a set is
    *larger* if it contains the first differing (smallest) attribute.
    """
    bits = bitset.unpack_bits(row, n_attrs)
    return tuple(int(b) for b in bits)
