"""Time K7 and K7b, the attention's forward and backward, of one or more
checkouts on one card.

    python3 tools/time_k7b.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one; an older commit unpacked with ``git archive`` into a git-ignored
directory).  For each TREE in the order given, a fresh process with
``TREE/src`` first on its path builds that tree's ``csrc/attention.cu``
(into ``TREE/build/kernels``) and times its ``attention_backward`` at
gemma2-9b's full-width layer (chip_smoke.py's ``K7B_TIMED``: B 1, S 4096,
16/8 heads of 256, bf16, seeded inputs) with the logit cap 50 and without
it, and the backward of ``scaled_dot_product_attention`` on the cap-free
shape.  It also times K7 (``_blockwise_forward``) on gemma2-9b's costliest
prefill chunk of chip_smoke.py's phase 11 (B 4, S 5000, 16/8 heads of 256,
bf16, cap 50, the prompts 7, 1024, 4097 and 5000 tokens long, left-padded:
``valid_from`` 4993, 3976, 903, 0), on the global layer (no window) and on
the local one (window 4096).  Times are medians of CUDA events behind a
spin kernel, as
chip_smoke.py takes them.  Where the tree's wrapper takes ``events``, the
three passes are also timed apart.  Name a tree twice (parent, change,
change, parent) to see the spread between runs.  Prints one JSON line per
run, then the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, statistics, sys
import torch
import torch.nn.functional as F
from repro_torch.kernels import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
B, S, H, KV, hd = 1, 4096, 16, 8, 256
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(7)
q, k, v, dout = (torch.randn(B, S, h, hd, generator=gen, device=dev, dtype=torch.bfloat16)
                 for h in (H, KV, KV, H))


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


rec = {}
gq, gk, gv = (torch.randn(4, 5000, h, hd, generator=gen, device=dev, dtype=torch.bfloat16)
              for h in (H, KV, KV))
vf = torch.tensor([4993, 3976, 903, 0], dtype=torch.int32, device=dev)
for name, window in (("k7_global_ms", None), ("k7_local_ms", 4096)):
    rec[name] = median_ms(lambda: fa._blockwise_forward(gq, gk, gv, window, 50.0, vf))
del gq, gk, gv
for name, cap in (("cap50", 50.0), ("cap_free", None)):
    out, lse = fa._blockwise_forward(q, k, v, None, cap, lse=True)
    rec[f"{name}_ms"] = median_ms(
        lambda: fa.attention_backward(q, k, v, out, lse, dout, window=None, logit_cap=cap))
    try:
        passes = []
        for _ in range(10):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda._sleep(1_000_000)
            fa.attention_backward(q, k, v, out, lse, dout, window=None, logit_cap=cap, events=ev)
            ev[3].synchronize()
            passes.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
        rec[f"{name}_pass_ms"] = [statistics.median(p[i] for p in passes) for i in range(3)]
    except TypeError:
        rec[f"{name}_pass_ms"] = None
qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
gt = dout.transpose(1, 2)
rec["sdpa_backward_ms"] = median_ms(
    lambda: torch.autograd.grad(sd, (qt, kt, vt), gt, retain_graph=True))
print(json.dumps(rec))
"""


def main(trees: list[str]) -> int:
    import torch

    if not trees or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **rec}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
