"""Quickstart on the PyTorch port: the paper's worked example end-to-end.

    PYTHONPATH=src python examples/quickstart_torch.py              # CUDA
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port of ``examples/quickstart.py``: mines the 21 formal concepts of
Table 1 with the centralized baselines (NextClosure, CloseByOne) and the
distributed MR* algorithms (MRGanter, MRGanter+, MRCbo) on the paper's
S_1/S_2 split (a simulated 2-shard plan, ``backend="kernel"``: on the card
K1, K3 and K4; on the CPU their plain versions), checks they agree, and
prints the concept lattice.  ``main`` returns each driver's concept count,
rounds and agreement.
"""

import argparse

import numpy as np

from repro_torch.core import (
    ClosureEngine,
    all_closures,
    bitset,
    close_by_one,
    mrcbo,
    mrganter,
    mrganter_plus,
    paper_context,
)
from repro_torch.core.lattice import build_lattice

NAMES = "abcdefg"


def fmt(row, n=7):
    return "{" + ",".join(NAMES[a] for a in range(n) if bitset.unpack_bits(row, n)[a]) + "}"


def main(device=None) -> dict:
    ctx = paper_context()
    print(f"context: {ctx.n_objects} objects × {ctx.n_attrs} attributes, "
          f"density {ctx.density:.2f}")

    ref = all_closures(ctx)
    print(f"\nNextClosure: {len(ref)} concepts (lectic order)")

    cbo = close_by_one(ctx)
    print(f"CloseByOne:  {len(cbo.intents)} concepts in {cbo.n_iterations} levels")

    out = {"nextclosure": len(ref), "closebyone": len(cbo.intents), "drivers": {}}
    for name, algo in [("MRGanter", mrganter), ("MRGanter+", mrganter_plus),
                       ("MRCbo", mrcbo)]:
        eng = ClosureEngine(ctx, n_parts=2, block_n=64, device=device)  # paper's S_1/S_2 split
        res = algo(ctx, eng)
        same = {bitset.key_bytes(y) for y in res.intents} == {
            bitset.key_bytes(y) for y in ref
        }
        print(f"{name:10s}: {res.n_concepts} concepts in {res.n_iterations:2d} "
              f"MapReduce rounds — matches NextClosure: {same}")
        out["drivers"][name] = {"concepts": res.n_concepts, "rounds": res.n_iterations,
                                "match": same}

    lat = build_lattice(ctx, ref)
    print("\nconcept lattice (intent ← covered intents):")
    for i in range(lat.n_concepts):
        kids = ", ".join(fmt(lat.intents[j]) for j in lat.children[i])
        ext = "".join(str(o + 1) for o in np.nonzero(lat.extents[i])[0])
        print(f"  ⟨{{{ext}}}, {fmt(lat.intents[i])}⟩  ←  [{kids}]")
    out["lattice"] = lat.n_concepts
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(device=p.parse_args().device)
