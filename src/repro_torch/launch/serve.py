"""LM serving launcher of the port: batched greedy/temperature generation.

    python -m repro_torch.launch.serve --arch gemma2-9b --max-new 16
    python -m repro_torch.launch.serve --arch codeqwen1.5-7b --reduced \\
        --prompts "1,2,3;4,5" --max-new 16 --device cpu

The flags and the printed lines (``<prompt> → <tokens>``, one per prompt)
are the reference's ``repro.launch.serve``.  Weights are made from seed 0
on the device (the numbers differ from the reference's ``jax.random``
init), or loaded with ``--weights`` from an ``.npz`` of a reference
parameter tree (``repro_torch.interop.flatten_tree`` keys), which gives the
reference's tokens.  ``--device`` defaults to ``cuda`` and the run fails
without a CUDA device unless ``--device cpu`` is given.  Every arch of
``repro_torch.configs`` serves (attention, Griffin, Mamba-2 and MoE
layers; the embeds archs take token ids here, as in the reference).  A
mamba2 prefill runs in chunks of ``min(chunk_size, L)`` and refuses a
padded prompt length that is longer than one chunk and not a multiple of
it (``ValueError``, as the reference).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax, unflatten_tree
from repro_torch.models.transformer import Decoder
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--prompts", default="1,2,3;4,5,6,7")
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--weights", default=None,
                   help=".npz of a reference parameter tree (flatten_tree keys)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Decoder(cfg, device=args.device, seed=None if args.weights else 0)
    if args.weights:
        with np.load(args.weights) as flat:
            model.load_state_dict(params_from_jax(unflatten_tree(dict(flat)), cfg))
    prompts = [
        [int(t) % cfg.vocab_size for t in chunk.split(",") if t.strip()]
        for chunk in args.prompts.split(";")
    ]
    eng = ServeEngine(
        cfg, model,
        ServeConfig(max_len=args.max_len, batch_slots=max(4, len(prompts)),
                    greedy=args.temperature == 0.0,
                    temperature=max(args.temperature, 1e-6)),
        device=args.device,
    )
    for prompt, out in zip(prompts, eng.generate(prompts, args.max_new)):
        print(f"{prompt} → {out}")


if __name__ == "__main__":
    main()
