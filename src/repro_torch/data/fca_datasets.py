"""FCA dataset pipeline: UCI loaders + offline synthetic stand-ins.

The paper evaluates on three UCI KDD datasets (Table 7):

    dataset        objects   attributes   density
    mushroom         8124       125        17.36 %
    anon-web        32711       294         1.03 %
    census-income  103950       133         6.70 %

This container is offline, so ``load(name)`` generates synthetic contexts
**matched in objects/attributes/density** (and with correlated column
structure so the concept lattice is non-trivial, unlike IID noise).  When a
real UCI file is present under ``data_dir`` it is binarized and used
instead; scale factors (for CPU-budget runs) shrink the object count while
preserving attribute count and density.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.core.context import FormalContext

PAPER_DATASETS = {
    # name: (objects, attributes, density)
    "mushroom": (8124, 125, 0.1736),
    "anon-web": (32711, 294, 0.0103),
    "census-income": (103950, 133, 0.067),
}


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_objects: int
    n_attrs: int
    density: float
    synthetic: bool


def _synthetic_correlated(
    n_objects: int, n_attrs: int, density: float, seed: int
) -> np.ndarray:
    """Synthetic context with block/cluster structure.

    Objects are drawn from a small number of latent 'profiles' (attribute
    subsets), plus Bernoulli noise calibrated so the *total* density matches
    the target.  Profiles create genuinely shared attribute sets, i.e. a
    rich concept lattice — matching the qualitative behaviour of the UCI
    categorical one-hot data far better than IID noise.
    """
    rng = np.random.default_rng(seed)
    n_profiles = max(4, n_attrs // 8)
    # Each profile activates ~density·n_attrs attributes.
    k = max(1, int(round(density * n_attrs)))
    profiles = np.zeros((n_profiles, n_attrs), dtype=bool)
    for p in range(n_profiles):
        profiles[p, rng.choice(n_attrs, size=k, replace=False)] = True
    assign = rng.integers(0, n_profiles, size=n_objects)
    dense = profiles[assign].copy()
    # Profile membership is kept with prob 0.85; noise fills the rest so the
    # expected density lands on target.
    keep = rng.random(dense.shape) < 0.85
    dense &= keep
    cur = dense.mean()
    if cur < density:
        p_noise = (density - cur) / max(1e-9, 1.0 - cur)
        dense |= rng.random(dense.shape) < p_noise
    return dense


def _binarize_categorical(rows: list[list[str]]) -> np.ndarray:
    """One-hot encode categorical CSV records (UCI mushroom-style)."""
    n_cols = len(rows[0])
    col_values: list[dict[str, int]] = [{} for _ in range(n_cols)]
    for r in rows:
        for c, v in enumerate(r):
            if v not in col_values[c]:
                col_values[c][v] = len(col_values[c])
    offsets = np.cumsum([0] + [len(cv) for cv in col_values[:-1]])
    n_attrs = int(offsets[-1] + len(col_values[-1]))
    dense = np.zeros((len(rows), n_attrs), dtype=bool)
    for i, r in enumerate(rows):
        for c, v in enumerate(r):
            dense[i, offsets[c] + col_values[c][v]] = True
    return dense


def load_uci_file(path: str) -> FormalContext:
    """Load a UCI categorical CSV (`.data`) into a context via one-hot."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(line.split(","))
    return FormalContext.from_dense(_binarize_categorical(rows))


def load(
    name: str,
    *,
    scale: float = 1.0,
    seed: int = 0,
    data_dir: str | None = None,
) -> tuple[FormalContext, DatasetSpec]:
    """Load a paper dataset (real if available, else matched synthetic)."""
    if name not in PAPER_DATASETS:
        raise ValueError(f"unknown dataset {name!r}; choose {list(PAPER_DATASETS)}")
    n_obj, n_attr, dens = PAPER_DATASETS[name]
    n_obj = max(8, int(round(n_obj * scale)))

    if data_dir:
        path = os.path.join(data_dir, f"{name}.data")
        if os.path.exists(path):
            ctx = load_uci_file(path)
            if scale < 1.0:
                keep = np.random.default_rng(seed).choice(
                    ctx.n_objects, size=n_obj, replace=False
                )
                ctx = FormalContext(
                    rows=ctx.rows[np.sort(keep)],
                    n_objects=n_obj,
                    n_attrs=ctx.n_attrs,
                )
            return ctx, DatasetSpec(name, ctx.n_objects, ctx.n_attrs, ctx.density, False)

    dense = _synthetic_correlated(n_obj, n_attr, dens, seed)
    ctx = FormalContext.from_dense(dense)
    return ctx, DatasetSpec(name, ctx.n_objects, ctx.n_attrs, ctx.density, True)
