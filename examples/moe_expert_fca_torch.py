"""FCA × MoE with the PyTorch port: mine expert co-activation concepts
from router decisions.

    PYTHONPATH=src python examples/moe_expert_fca_torch.py              # CUDA
    PYTHONPATH=src python examples/moe_expert_fca_torch.py --device cpu

The port of ``examples/moe_expert_fca.py``.  A top-k router induces a
Boolean relation *tokens × experts* — a formal context — whose concept
lattice says which expert subsets fire together on which token subsets.
llama4-scout ``reduced()`` with 8 experts top-2 (seeded weights on the
device) routes the first MoE layer on ``lm_data``'s synthetic batches; the
port's MRGanter+ (local pruning) mines the context on a simulated 4-shard
``rsag`` plan with ``backend="kernel"``: on the card through K3 and K4, on
the CPU through their plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ClosureEngine, FormalContext, bitset, mrganter_plus
from repro_torch.core.closure import extent_np
from repro_torch.data.lm_data import make_batch_iterator
from repro_torch.models import moe
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder


def example_config():
    """llama4-scout ``reduced()`` with 8 experts top-2 (the reference
    example's)."""
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2))


def batches(cfg, n_batches: int, seed: int = 0) -> list:
    """The token ids of ``n_batches`` synthetic batches of 8 × 64."""
    it = make_batch_iterator(cfg, ShapeConfig("fca", "train", 64, 8), seed=seed)
    return [next(it)[1]["inputs"] for _ in range(n_batches)]


@torch.inference_mode()
def routing_rows(model: Decoder, token_batches) -> np.ndarray:
    """The first MoE layer's top-k decisions on the raw embeddings, as the
    reference example routes: bool [tokens, experts]."""
    router = model.moe_layers()[0].router
    k = model.cfg.moe.top_k
    rows = []
    for tokens in token_batches:
        x = model.embed[torch.from_numpy(np.asarray(tokens)).to(model.device)].float()
        _, _, top_i = moe.route(router, x.reshape(-1, model.cfg.d_model), k)
        onehot = torch.zeros((top_i.shape[0], router.shape[1]), dtype=torch.bool,
                             device=top_i.device)
        onehot.scatter_(1, top_i, True)
        rows.append(onehot.cpu().numpy())
    return np.concatenate(rows, axis=0)


def mine(rows: np.ndarray, device=None):
    """MRGanter+ with local pruning over a simulated 4-shard rsag plan →
    (context, result)."""
    ctx = FormalContext.from_dense(rows)
    eng = ClosureEngine(ctx, n_parts=4, reduce_impl="rsag", backend="kernel", device=device)
    return ctx, mrganter_plus(ctx, eng, dedupe_candidates=True)


def main(n_batches: int = 4, device=None):
    cfg = example_config()
    model = Decoder(cfg, device=device, seed=0)
    rows = routing_rows(model, batches(cfg, n_batches))
    ctx, res = mine(rows, device=model.device)
    print(f"routing context: {ctx.n_objects} tokens × {ctx.n_attrs} experts, "
          f"density {ctx.density:.3f} (≈ top_k/E = {cfg.moe.top_k / cfg.moe.n_experts:.3f})")
    print(f"MRGanter+: {res.n_concepts} expert co-activation concepts "
          f"in {res.n_iterations} rounds\n")
    print("most-supported non-trivial expert subsets:")
    scored = []
    for y in res.intents:
        size = int(bitset.popcount(y))
        if 0 < size < cfg.moe.n_experts:
            scored.append((int(extent_np(ctx.rows, y).sum()), size, y))
    for support, _, y in sorted(scored, key=lambda s: (s[0], s[1], s[2].tobytes()),
                                reverse=True)[:10]:
        experts = np.flatnonzero(bitset.unpack_bits(y, ctx.n_attrs)).tolist()
        print(f"  experts {experts}  ← {support} tokens")
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args()
    main(a.batches, a.device)
