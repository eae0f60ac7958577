"""Basis extraction: Duquenne–Guigues implications + Luxenburger rules.

Both bases are computed *from the mined concept family* (a full lattice or
an iceberg): the family of (frequent) closed intents is closed under
intersection, so

    φ(X) = ⋂ { Y ∈ family : X ⊆ Y }          (⋂ ∅ = M, the full attr set)

is a closure operator whose closed sets are exactly the family (+ M).

  * **Duquenne–Guigues base** — ``{P → φ(P)\\P : P pseudo-closed}``,
    enumerated with Ganter's attribute-exploration loop: NextClosure over
    the *implication closure* (L-saturation) visits every φ-closed and
    pseudo-closed set in lectic order; each visited set that φ grows is a
    pseudo-intent.  The two inner passes — L-saturation of all m candidate
    seeds and the φ pass — are batched torch passes over the intent table;
    the host loop is the sequential NextClosure control flow.
    ``dg_basis_host`` is the pure numpy brute-force oracle.
  * **Luxenburger base** — one rule per *covering* pair Y₁ ≺ Y₂ of the
    family (premise Y₁, added attrs Y₂\\Y₁, confidence supp(Y₂)/supp(Y₁)),
    the covering read from the store snapshot's order tables.
    ``luxenburger_host`` recomputes the covering with O(C²) loops.

Both paths emit rules in the same canonical order (lexsort over packed
premise then added words).  The rule arithmetic — the canonical order,
the float64 → float32 confidence, the float32 lift — is a numpy copy of
the reference's, so the floats come out bit for bit.  The torch passes
build ``[b, rows, W]`` intermediates a chunk of queries at a time
(results are per query row, so chunking changes no bit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset, lectic
from repro_torch.device import ALL_ONES, device_bits, host_bits, resolve_device
from repro_torch.kernels.closure import and_reduce
from repro_torch.kernels.ops import bucket_size
from repro_torch.kernels.serve import or_reduce

# Bound on the [b, rows, W] intermediates of the batched passes, in elements.
CHUNK_ELEMS = 1 << 24


def _row_chunks(X: torch.Tensor, rows: int):
    step = max(1, CHUNK_ELEMS // max(1, rows * X.shape[1]))
    for lo in range(0, X.shape[0], step):
        yield lo, X[lo : lo + step]


# ---------------------------------------------------------------------------
# device passes over the intent table
# ---------------------------------------------------------------------------


def family_closure(
    X: torch.Tensor, intents: torch.Tensor, n_concepts: int, mask: torch.Tensor
) -> torch.Tensor:
    """φ(X) for a batch [B, W]: AND-fold of the family intents ⊇ X.

    ``intents`` is a padded [Cb, W] table (pads masked by ``n_concepts``);
    a batch row covered by no intent closes to ``mask`` (= M).
    """
    Cb = intents.shape[0]
    valid = torch.arange(Cb, device=X.device) < n_concepts
    out = torch.empty_like(X)
    for lo, x in _row_chunks(X, Cb):
        covers = ((x[:, None, :] & ~intents[None, :, :]) == 0).all(-1) & valid[None, :]
        sel = torch.where(covers[:, :, None], intents[None], ALL_ONES)
        out[lo : lo + x.shape[0]] = and_reduce(sel, dim=1)
    return out & mask


def family_support(
    X: torch.Tensor, intents: torch.Tensor, supports: torch.Tensor, n_concepts: int
) -> torch.Tensor:
    """Support of each batch row *as a family member* (0 when absent —
    callers pass φ-closed rows, so absent ⟺ infrequent/M)."""
    Cb = intents.shape[0]
    valid = torch.arange(Cb, device=X.device) < n_concepts
    out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    for lo, x in _row_chunks(X, Cb):
        eq = (x[:, None, :] == intents[None, :, :]).all(-1) & valid[None, :]
        out[lo : lo + x.shape[0]] = torch.where(eq, supports[None, :], 0).max(1).values
    return out


def lclosure(
    X: torch.Tensor, premises: torch.Tensor, added: torch.Tensor, n_rules: int
) -> torch.Tensor:
    """Implication saturation of a batch [B, W] to the L-closure fixpoint.

    One pass ORs every applicable conclusion in; passes repeat until one
    changes nothing (≤ |L| passes, in practice a handful) — the
    reference's while-loop, with one host check per pass.
    """
    R = premises.shape[0]
    rvalid = torch.arange(R, device=X.device) < n_rules

    def one_pass(x_all):
        grow = torch.empty_like(x_all)
        for lo, x in _row_chunks(x_all, R):
            app = ((premises[None, :, :] & ~x[:, None, :]) == 0).all(-1) & rvalid[None, :]
            grow[lo : lo + x.shape[0]] = or_reduce(
                torch.where(app[:, :, None], added[None], 0), dim=1)
        return x_all | grow

    prev, cur = X, one_pass(X)
    while not torch.equal(prev, cur):
        prev, cur = cur, one_pass(cur)
    return cur


def _dg_next(
    A: torch.Tensor,
    premises: torch.Tensor,
    added: torch.Tensor,
    n_rules: int,
    LOW: torch.Tensor,
    BIT: torch.Tensor,
    *,
    n_attrs: int,
) -> torch.Tensor:
    """NextClosure step for the L-closure operator: the lectic-next
    L-closed set after ``A``.  All m candidate seeds saturate in one
    batched pass; the largest feasible generator wins."""
    seeds = (A[None, :] & LOW) | BIT  # [m, W]
    closed = lclosure(seeds, premises, added, n_rules)
    member = lectic.member_bits_torch(A[None, :], n_attrs)[0]
    gens = torch.arange(n_attrs, dtype=torch.int32, device=A.device)
    ok = lectic.feasible_torch(closed, A[None, :], gens, LOW) & ~member
    score = torch.where(ok, gens, -1)
    return closed[score.argmax()]


# ---------------------------------------------------------------------------
# rule containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """A batch of rules premise → premise ∪ added, canonical order."""

    premise: np.ndarray  # [R, W] uint32
    added: np.ndarray  # [R, W] uint32 (disjoint from premise)
    support: np.ndarray  # [R] int32 — objects matching premise ∪ added
    confidence: np.ndarray  # [R] float32
    lift: np.ndarray  # [R] float32 (0 when the consequent leaves the family)

    def __len__(self) -> int:
        return self.premise.shape[0]

    @staticmethod
    def empty(W: int) -> "RuleSet":
        z = np.zeros((0, W), np.uint32)
        return RuleSet(
            premise=z,
            added=z.copy(),
            support=np.zeros((0,), np.int32),
            confidence=np.zeros((0,), np.float32),
            lift=np.zeros((0,), np.float32),
        )

    @staticmethod
    def concat(a: "RuleSet", b: "RuleSet") -> "RuleSet":
        return RuleSet(
            premise=np.concatenate([a.premise, b.premise]),
            added=np.concatenate([a.added, b.added]),
            support=np.concatenate([a.support, b.support]),
            confidence=np.concatenate([a.confidence, b.confidence]),
            lift=np.concatenate([a.lift, b.lift]),
        )


@dataclasses.dataclass(frozen=True)
class RuleBasis:
    """The two-part basis of the mined family: exact rules (DG) + partial
    rules (Luxenburger)."""

    n_objects: int
    n_attrs: int
    min_conf: float
    implications: RuleSet  # confidence ≡ 1
    partial: RuleSet  # confidence < 1

    @property
    def n_implications(self) -> int:
        return len(self.implications)

    @property
    def n_partial(self) -> int:
        return len(self.partial)

    def combined(self) -> RuleSet:
        return RuleSet.concat(self.implications, self.partial)

    def describe(self) -> dict:
        return {
            "implications": self.n_implications,
            "partial_rules": self.n_partial,
            "min_conf": self.min_conf,
            "n_objects": self.n_objects,
            "n_attrs": self.n_attrs,
        }


def _canonical_rule_order(premise: np.ndarray, added: np.ndarray) -> np.ndarray:
    keys = tuple(added[:, w] for w in reversed(range(added.shape[1])))
    keys += tuple(premise[:, w] for w in reversed(range(premise.shape[1])))
    return np.lexsort(keys)


def _padded_family(intents_np: np.ndarray, W: int, device) -> tuple[torch.Tensor, int]:
    C = intents_np.shape[0]
    cap = bucket_size(max(1, C), minimum=8)
    buf = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    buf[:C] = intents_np
    return device_bits(buf, device), C


def _padded_supports(supports_np: np.ndarray, cap: int, device) -> torch.Tensor:
    buf = np.zeros((cap,), np.int32)
    buf[: supports_np.shape[0]] = supports_np
    return torch.from_numpy(buf).to(device)


def _consequent_lift(
    added: np.ndarray,
    confidence: np.ndarray,
    intents_dev: torch.Tensor,
    supports_dev: torch.Tensor,
    n_concepts: int,
    n_objects: int,
    mask: torch.Tensor,
) -> np.ndarray:
    """lift = conf · |O| / supp(φ(added)), batched; 0 when φ(added) has
    left the family (infrequent consequent in an iceberg store)."""
    if added.shape[0] == 0:
        return np.zeros((0,), np.float32)
    out = np.zeros((added.shape[0],), np.float32)
    step = 4096
    for lo in range(0, added.shape[0], step):
        chunk = device_bits(added[lo : lo + step], intents_dev.device)
        phi = family_closure(chunk, intents_dev, n_concepts, mask)
        s = (
            family_support(phi, intents_dev, supports_dev, n_concepts)
            .cpu().numpy().astype(np.float32)
        )
        conf = confidence[lo : lo + step]
        out[lo : lo + step] = np.where(s > 0, conf * n_objects / np.maximum(s, 1), 0.0)
    return out


# ---------------------------------------------------------------------------
# Duquenne–Guigues base
# ---------------------------------------------------------------------------


def dg_basis(
    intents_np: np.ndarray,
    supports_np: np.ndarray,
    n_attrs: int,
    *,
    n_objects: int | None = None,
    device=None,
) -> RuleSet:
    """DG implication base of the family, device-batched Ganter loop.

    Every iteration runs two device passes — L-saturation of the m
    candidate seeds (``_dg_next``) and the φ pass over the intent table —
    while the host only sequences NextClosure and collects pseudo-intents.
    Premises come out in lectic order.  ``device`` is CUDA unless the
    caller says so.
    """
    device = resolve_device(device)
    W = bitset.n_words(n_attrs)
    mask_np = bitset.attr_mask(n_attrs, W)
    mask = device_bits(mask_np, device)
    t = lectic.LecticTables(n_attrs)
    LOW, BIT = device_bits(t.LOW, device), device_bits(t.BIT, device)
    intents_dev, C = _padded_family(intents_np, W, device)
    supports_dev = _padded_supports(supports_np.astype(np.int32), intents_dev.shape[0], device)

    premises: list[np.ndarray] = []
    conclusions: list[np.ndarray] = []  # full φ(P), for the saturation
    # device twin of the growing L, bucket-padded (rebuilt on growth —
    # one tiny upload per pseudo-intent)
    rcap = 8
    prem_dev = torch.full((rcap, W), ALL_ONES, dtype=torch.int32, device=device)
    concl_dev = torch.zeros((rcap, W), dtype=torch.int32, device=device)

    A = np.zeros((W,), np.uint32)
    while True:
        phi = host_bits(family_closure(device_bits(A[None, :], device), intents_dev, C,
                                       mask))[0]
        if not np.array_equal(phi, A):  # A is pseudo-closed
            premises.append(A.copy())
            conclusions.append(phi)
            if len(premises) > rcap:
                rcap = bucket_size(len(premises), minimum=8)
            buf_p = np.full((rcap, W), 0xFFFFFFFF, np.uint32)
            buf_c = np.zeros((rcap, W), np.uint32)
            buf_p[: len(premises)] = np.stack(premises)
            buf_c[: len(premises)] = np.stack(conclusions)
            prem_dev, concl_dev = device_bits(buf_p, device), device_bits(buf_c, device)
        if np.array_equal(A, mask_np):
            break
        A = host_bits(_dg_next(device_bits(A, device), prem_dev, concl_dev,
                               len(premises), LOW, BIT, n_attrs=n_attrs))

    if not premises:
        return RuleSet.empty(W)
    prem = np.stack(premises)
    concl = np.stack(conclusions)
    added = concl & ~prem
    support = (
        family_support(device_bits(concl, device), intents_dev, supports_dev, C)
        .cpu().numpy().astype(np.int32)
    )
    confidence = np.ones((prem.shape[0],), np.float32)
    # |O| defaults to the top concept's support (extent of ∅'' is O)
    n_obj = n_objects if n_objects is not None else (int(supports_np.max()) if C else 0)
    lift = _consequent_lift(added, confidence, intents_dev, supports_dev, C, n_obj, mask)
    return RuleSet(
        premise=prem, added=added, support=support, confidence=confidence, lift=lift,
    )


def dg_basis_host(intents_np: np.ndarray, n_attrs: int) -> RuleSet:
    """Pure-numpy brute-force oracle for :func:`dg_basis` (supports and
    lifts zeroed — oracle comparisons cover premises/conclusions)."""
    W = bitset.n_words(n_attrs)
    mask = bitset.attr_mask(n_attrs, W)
    t = lectic.LecticTables(n_attrs)

    def phi(X):
        out = mask.copy()
        for Y in intents_np:
            if bool(bitset.is_subset(X, Y)):
                out &= Y
        return out

    def lclose(X, L):
        X = X.copy()
        changed = True
        while changed:
            changed = False
            for p, c in L:
                if bool(bitset.is_subset(p, X)) and not bool(bitset.is_subset(c, X)):
                    X |= c
                    changed = True
        return X

    L: list[tuple[np.ndarray, np.ndarray]] = []
    A = np.zeros((W,), np.uint32)
    while True:
        p = phi(A)
        if not np.array_equal(p, A):
            L.append((A.copy(), p))
        if np.array_equal(A, mask):
            break
        for i in reversed(range(n_attrs)):
            if bitset.unpack_bits(A, n_attrs)[i]:
                continue
            B = lclose((A & t.LOW[i]) | t.BIT[i], L)
            if bool(np.all(((B ^ A) & t.LOW[i]) == 0)):
                A = B
                break
        else:  # pragma: no cover — NextClosure always has a successor
            raise AssertionError("no lectic successor below M")

    if not L:
        return RuleSet.empty(W)
    prem = np.stack([p for p, _ in L])
    concl = np.stack([c for _, c in L])
    R = prem.shape[0]
    return RuleSet(
        premise=prem, added=concl & ~prem,
        support=np.zeros((R,), np.int32),
        confidence=np.ones((R,), np.float32),
        lift=np.zeros((R,), np.float32),
    )


# ---------------------------------------------------------------------------
# Luxenburger base
# ---------------------------------------------------------------------------


def _rules_from_cover(
    cover_target_child: np.ndarray,  # bool [C, C]: [c, d] ⇒ d ≺ c (d child)
    intents_np: np.ndarray,
    supports_np: np.ndarray,
    n_objects: int,
    min_conf: float,
    intents_dev: torch.Tensor,
    supports_dev: torch.Tensor,
    n_concepts: int,
    mask: torch.Tensor,
) -> RuleSet:
    tgt, src = np.nonzero(cover_target_child)  # rule: intent[src] → intent[tgt]
    keep = supports_np[src] > 0
    tgt, src = tgt[keep], src[keep]
    premise = intents_np[src]
    added = intents_np[tgt] & ~premise
    support = supports_np[tgt].astype(np.int32)
    confidence = (
        support.astype(np.float64) / supports_np[src].astype(np.float64)
    ).astype(np.float32)
    keep = confidence >= np.float32(min_conf)
    premise, added = premise[keep], added[keep]
    support, confidence = support[keep], confidence[keep]
    lift = _consequent_lift(
        added, confidence, intents_dev, supports_dev, n_concepts, n_objects, mask,
    )
    order = _canonical_rule_order(premise, added)
    return RuleSet(
        premise=premise[order], added=added[order],
        support=support[order], confidence=confidence[order],
        lift=lift[order],
    )


def _m_mask(W: int, n_attrs: int | None) -> np.ndarray:
    """The top element M for the φ no-cover fallback.  ``n_attrs=None``
    falls back to every bit of the W words — only reachable by callers
    that pass sets no family member covers, which the Luxenburger paths
    never do (every consequent is a subset of a real intent)."""
    if n_attrs is not None:
        return bitset.attr_mask(n_attrs, W)
    return np.full((W,), 0xFFFFFFFF, np.uint32)


def luxenburger_from_snapshot(
    snap, n_objects: int, *, min_conf: float = 0.0, n_attrs: int | None = None,
) -> RuleSet:
    """Luxenburger base read off a ConceptStore snapshot: premises/targets
    are the covering pairs the snapshot's order-table matmuls already
    materialized (``children_rows``)."""
    C = snap.n_concepts
    W = snap.intents_np.shape[1]  # valid even for an empty family
    if C == 0:
        return RuleSet.empty(W)
    kids = host_bits(snap.children_rows)[:C]
    cover = bitset.unpack_bits(kids, snap.cap)[:, :C]  # [c, d]: d ≺ c
    return _rules_from_cover(
        cover, snap.intents_np, snap.supports_np.astype(np.int32),
        n_objects, min_conf, snap.intents, snap.supports, C,
        device_bits(_m_mask(W, n_attrs), snap.intents.device),
    )


def luxenburger_host(
    intents_np: np.ndarray,
    supports_np: np.ndarray,
    n_objects: int,
    *,
    min_conf: float = 0.0,
    n_attrs: int | None = None,
    device=None,
) -> RuleSet:
    """Brute-force oracle: O(C²) subset loops build the strict order, a
    triple loop reduces it to the covering, then the same rule math."""
    C, W = intents_np.shape
    if C == 0:
        return RuleSet.empty(W)
    device = resolve_device(device)
    strict = np.zeros((C, C), bool)
    for i in range(C):
        for j in range(C):
            if i != j and bool(bitset.is_subset(intents_np[i], intents_np[j])):
                strict[i, j] = True  # intent_i ⊂ intent_j
    cover = strict.copy()
    for i in range(C):
        for j in range(C):
            if cover[i, j]:
                for k in range(C):
                    if strict[i, k] and strict[k, j]:
                        cover[i, j] = False
                        break
    # cover[i, j]: j covers i (premise i → target j) → [target, child] layout
    intents_dev, C_ = _padded_family(intents_np, W, device)
    supports_dev = _padded_supports(supports_np.astype(np.int32), intents_dev.shape[0],
                                    device)
    return _rules_from_cover(
        cover.T, intents_np, supports_np.astype(np.int32), n_objects,
        min_conf, intents_dev, supports_dev, C_,
        device_bits(_m_mask(W, n_attrs), device),
    )


# ---------------------------------------------------------------------------
# one-call extraction over a concept store
# ---------------------------------------------------------------------------


def extract_bases(store, *, min_conf: float = 0.0) -> RuleBasis:
    """DG + Luxenburger bases of the store's active snapshot (full or
    iceberg — φ is the snapshot family's closure system either way), on
    the store's device."""
    snap = store.snapshot
    ctx = store.ctx
    implications = dg_basis(
        snap.intents_np, snap.supports_np.astype(np.int32), ctx.n_attrs,
        n_objects=ctx.n_objects, device=store.device,
    )
    partial = luxenburger_from_snapshot(
        snap, ctx.n_objects, min_conf=min_conf, n_attrs=ctx.n_attrs
    )
    return RuleBasis(
        n_objects=ctx.n_objects,
        n_attrs=ctx.n_attrs,
        min_conf=min_conf,
        implications=implications,
        partial=partial,
    )
