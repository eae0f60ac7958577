#!/usr/bin/env python3
"""Smoke run of repro_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
checks, on the card:

  1. device  — the card's name and power limit (``nvidia-smi``);
  2. build   — every kernel source, one ``nvcc`` per source, in parallel;
  3. kernels — K1 (closure) and K2 (fused frontier step) against their
     plain PyTorch versions on seeded inputs, bit for bit, including
     widths whose shared memory needs more than 48 KB, up to ``MAX_W``;
  4. main path — MRGanter+ (local pruning) and MRCbo on the full-scale
     mushroom context (8124 x 125) at min_support=406 through
     ``backend="kernel"``: concept, iteration and closure counts equal the
     reference's, concept sets equal the ``backend="torch"`` run's, and
     every kernel of the path was launched; one more kernel run keeps a
     copy of the operands of every launch;
  5. full lattice — MRGanter+ and MRCbo on mushroom at scale 0.01, and all
     three drivers on the paper's example and a seeded synthetic context,
     against the NextClosure / CloseByOne oracles;
  6. times — each kernel on every chunk phase 4 gave it (CUDA events,
     median of 25 after warm-up): the sum over the run and its bound, and
     the costliest chunk beside its plain version and its bound.

Any failed check raises and the script exits non-zero.  The second-to-last
line is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  It needs one card and exits non-zero
without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Reference values of the main path and the full lattices (the JAX package,
# backend="jnp", same contexts).
MAIN_MIN_SUPPORT = 406
MAIN_EXPECTED = {
    "mrganter+": {"concepts": 4282, "iterations": 8, "closures": 180_611},
    "mrcbo": {"concepts": 4282, "iterations": 8, "closures": 139_782},
}
LATTICE_EXPECTED = {
    "paper": {"concepts": 21, "iterations": {"mrganter": 21, "mrganter+": 5, "mrcbo": 5}},
    "synthetic": {"concepts": 1751, "iterations": {"mrganter": 1751, "mrganter+": 7, "mrcbo": 8}},
    "mushroom-0.01": {"concepts": 4440, "iterations": {"mrganter+": 7, "mrcbo": 10}},
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# 32-bit integer add/compare/bitwise results per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table); times the SM count and the maximum SM clock.
INT32_OPS_PER_CLK_PER_SM = 64
TIMING_REPS = 25


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest absolute difference over the outputs, as integers."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def require_equal(name: str, got, want) -> int:
    import torch

    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max |err| {err})")
    return err


def bitsets(rng, n: int, W: int, density: float):
    """Seeded random packed rows [n, W] as uint32 (bit 31 included)."""
    import numpy as np

    dense = rng.random((n, W * 32)) < density
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (dense.reshape(n, W, 32).astype(np.uint32) * weights).sum(-1, dtype=np.uint32)


def candidates(rng, rows, B: int):
    """Subsets of random rows (so supports are non-trivial), plus the empty
    and the all-ones candidate."""
    import numpy as np

    W = rows.shape[1]
    keep = bitsets(rng, B, W, 0.15)
    cands = rows[rng.integers(0, rows.shape[0], size=B)] & keep
    cands[0] = 0
    if B > 1:
        cands[-1] = 0xFFFFFFFF
    return cands


def check_kernels(device) -> list[dict]:
    """Phase 3: K1 and K2 against their plain versions, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.device import device_bits
    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as k2
    from repro_torch.kernels import ops

    rng = np.random.default_rng(20121013)
    records = []
    for W in (1, 4, 5, 10, 33):
        for N in (256, 8192):
            rows_np = bitsets(rng, N, W, 0.7)
            rows = device_bits(rows_np, device)
            for B in (1, 8, 8192):
                cands = device_bits(candidates(rng, rows_np, B), device)
                got = k1.closure(rows, cands)
                want = k1.closure_plain(rows, cands)
                require_equal(f"K1 W={W} N={N} B={B}", got, want)
                records.append({"kernel": "closure", "W": W, "N": N, "B": B,
                                "max_support": int(want[1].max())})
    # widths whose shared memory needs more than the 48 KB default (the
    # launch raises the kernel's limit), up to the wrappers' MAX_W
    for W in (2000, k1.MAX_W):
        rows_np = bitsets(rng, 256, W, 0.7)
        rows = device_bits(rows_np, device)
        for B in (8, 16):
            cands_np = candidates(rng, rows_np, B)
            cands = device_bits(cands_np, device)
            require_equal(f"K1 W={W} N=256 B={B}", k1.closure(rows, cands),
                          k1.closure_plain(rows, cands))
            records.append({"kernel": "closure", "W": W, "N": 256, "B": B})
            mask = ops.attr_mask_tensor(W * 32 - 5, W, device)[None, :]
            parent = device_bits(cands_np & bitsets(rng, B, W, 0.5), device)
            lowrow = device_bits(bitsets(rng, B, W, 0.3), device)
            sc = k2.pack_scalars(B - 1, 1, 3, 0)
            for variant, (iceberg, cbo, _) in k2.VARIANTS.items():
                kw = dict(iceberg=iceberg, cbo=cbo)
                if cbo:
                    kw.update(parent=parent, lowrow=lowrow)
                require_equal(f"K2 {variant} W={W} N=256 B={B}",
                              k2.fused_step(rows, cands, mask, sc, **kw),
                              k2.fused_step_plain(rows, cands, mask, sc, **kw))
                records.append({"kernel": "fused_step", "variant": variant, "W": W,
                                "N": 256, "B": B})
    # ragged N and B: the batched_closure wrapper pads both with all-ones rows
    for W, N, B, n_valid in ((4, 1000, 13, 990), (5, 8124, 125, 8124), (33, 300, 1, 300)):
        rows_np = bitsets(rng, N, W, 0.7)
        rows = device_bits(rows_np, device)
        cands = device_bits(candidates(rng, rows_np, B), device)
        n_attrs = W * 32 - 3
        got = ops.batched_closure(rows, cands, n_attrs, n_valid_rows=n_valid)
        want = ops.batched_closure(rows, cands, n_attrs, n_valid_rows=n_valid, use_kernel=False)
        require_equal(f"batched_closure W={W} N={N} B={B}", got, want)
        records.append({"kernel": "closure", "ragged": True, "W": W, "N": N, "B": B})
    # K2: every variant, with windows, thresholds and CbO operands
    for W, N, B in ((4, 8192, 8192), (5, 512, 40), (1, 256, 8)):
        rows_np = bitsets(rng, N, W, 0.7)
        rows = device_bits(rows_np, device)
        cands_np = candidates(rng, rows_np, B)
        cands = device_bits(cands_np, device)
        n_attrs = W * 32 - 7
        mask = ops.attr_mask_tensor(n_attrs, W, device)[None, :]
        parent = device_bits(cands_np & bitsets(rng, B, W, 0.5), device)
        lowrow = device_bits(bitsets(rng, B, W, 0.3), device)
        for variant, (iceberg, cbo, _) in k2.VARIANTS.items():
            for n_valid, min_sup, n_pad, row_off in (
                (B, 1, 0, 0), (B - B // 3, N // 50, 5, 0), (B // 2 + 1, 3, 1, B // 4),
            ):
                sc = k2.pack_scalars(n_valid, min_sup, n_pad, row_off)
                kw = dict(iceberg=iceberg, cbo=cbo)
                if cbo:
                    kw.update(parent=parent, lowrow=lowrow)
                got = k2.fused_step(rows, cands, mask, sc, **kw)
                want = k2.fused_step_plain(rows, cands, mask, sc, **kw)
                require_equal(f"K2 {variant} W={W} N={N} B={B} {sc}", got, want)
                records.append({"kernel": "fused_step", "variant": variant, "W": W,
                                "N": N, "B": B, "scalars": list(sc),
                                "kept": int(want[2].sum())})
    return records


def drive_main_path(ctx, backend: str, algorithm: str, device):
    """One phase-4 run through the port's entry points; launch counts are
    set to 0 just before it and read just after."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import ClosureEngine, mrcbo, mrganter_plus

    eng = ClosureEngine(ctx, backend=backend, device=device)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if algorithm == "mrganter+":
        res = mrganter_plus(ctx, eng, local_prune=True, min_support=MAIN_MIN_SUPPORT)
    else:
        res = mrcbo(ctx, eng, min_support=MAIN_MIN_SUPPORT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    return res, eng, wall, launches


def capture_launches(ctx, algorithm: str, device):
    """One more kernel-backend run of the main path that keeps a copy of the
    operands of every kernel launch, so that phase 6 times and bounds the
    chunks the path really gave each kernel."""
    import torch

    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as k2

    real = {"closure": k1.closure, "fused_step": k2.fused_step}
    chunks = {name: [] for name in real}

    def recorder(name):
        def call(*args, **kw):
            if args[1].shape[0] > 0:  # an empty batch launches nothing
                chunks[name].append((
                    [a.clone() if torch.is_tensor(a) else a for a in args],
                    {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()},
                ))
            return real[name](*args, **kw)
        # the wrapper counts on its module-level name, now this recorder
        call.launches = 0
        return call

    recorders = {name: recorder(name) for name in real}
    k1.closure, k2.fused_step = recorders["closure"], recorders["fused_step"]
    try:
        res, _, _, _ = drive_main_path(ctx, "kernel", algorithm, device)
    finally:
        k1.closure, k2.fused_step = real["closure"], real["fused_step"]
    for name, rec in recorders.items():
        if len(chunks[name]) != rec.launches:
            raise AssertionError(
                f"captured {len(chunks[name])} {name} chunks, counted {rec.launches} launches")
    return res, chunks


def intent_set(intents) -> set:
    return {x.tobytes() for x in intents}


def run_main_path(device) -> tuple[dict, dict]:
    """Phase 4: full-scale mushroom, iceberg at 5 %, both drivers."""
    from repro_torch.data import fca_datasets

    ctx, spec = fca_datasets.load("mushroom", scale=1.0)
    if (ctx.n_objects, ctx.n_attrs) != (8124, 125):
        raise AssertionError(f"mushroom context is {ctx.n_objects} x {ctx.n_attrs}")
    launches = {"closure": 0, "fused_step": 0}
    chunks = {"closure": [], "fused_step": []}
    report = {}
    for algorithm, want in MAIN_EXPECTED.items():
        # kernel, torch, torch, kernel: the first run of each backend is cold
        runs = [drive_main_path(ctx, backend, algorithm, device)
                for backend in ("kernel", "torch", "torch", "kernel")]
        captured_res, captured = capture_launches(ctx, algorithm, device)
        res, eng, _, counts = runs[0]
        for run_res in [r[0] for r in runs] + [captured_res]:
            got = {"concepts": run_res.n_concepts, "iterations": run_res.n_iterations,
                   "closures": run_res.n_closures_computed}
            if got != want:
                raise AssertionError(f"main path {algorithm}: {got} != reference {want}")
            if intent_set(run_res.intents) != intent_set(res.intents):
                raise AssertionError(f"main path {algorithm}: kernel and torch concept sets differ")
        if runs[3][3] != counts or {k: len(v) for k, v in captured.items()} != counts:
            raise AssertionError(f"main path {algorithm}: launch counts differ between runs")
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            raise AssertionError(f"main path {algorithm}: kernels never launched: {missing}")
        for k, n in counts.items():
            launches[k] += n
            chunks[k] += [(algorithm, args, kw) for args, kw in captured[k]]
        report[algorithm] = dict(
            got, launches=counts, rounds=eng.stats.rounds,
            kernel_wall_s={"cold": runs[0][2], "warm": runs[3][2]},
            torch_wall_s={"cold": runs[1][2], "warm": runs[2][2]},
            host_blocked_s=runs[3][1].stats.host_blocked_s,
            modeled_comm_bytes=res.modeled_comm_bytes,
        )
        emit({"phase": "main_path", "dataset": spec.name, "objects": ctx.n_objects,
              "attributes": ctx.n_attrs, "min_support": MAIN_MIN_SUPPORT,
              "algorithm": algorithm, **report[algorithm]})
    return report, launches, chunks


def run_full_lattices(device) -> dict:
    """Phase 5: full lattices against the centralized oracles."""
    from repro_torch.core import (
        ClosureEngine, FormalContext, all_closures, close_by_one,
        mrcbo, mrganter, mrganter_plus, paper_context,
    )
    from repro_torch.data import fca_datasets

    drivers = {
        "mrganter": lambda c, e: mrganter(c, e),
        "mrganter+": lambda c, e: mrganter_plus(c, e, dedupe_candidates=True),
        "mrcbo": lambda c, e: mrcbo(c, e),
    }
    contexts = {
        "paper": (paper_context(), all_closures),
        "synthetic": (FormalContext.synthetic(60, 24, 0.35, seed=42), all_closures),
        "mushroom-0.01": (fca_datasets.load("mushroom", scale=0.01)[0],
                          lambda c: close_by_one(c).intents),
    }
    report = {}
    for name, (ctx, oracle) in contexts.items():
        want = LATTICE_EXPECTED[name]
        oracle_set = intent_set(oracle(ctx))
        if len(oracle_set) != want["concepts"]:
            raise AssertionError(f"{name}: oracle has {len(oracle_set)} concepts")
        for algorithm, n_iter in want["iterations"].items():
            eng = ClosureEngine(ctx, backend="kernel", device=device)
            t0 = time.perf_counter()
            res = drivers[algorithm](ctx, eng)
            wall = time.perf_counter() - t0
            if res.n_concepts != want["concepts"] or intent_set(res.intents) != oracle_set:
                raise AssertionError(f"{name} {algorithm}: concept set differs from the oracle")
            if res.n_iterations != n_iter:
                raise AssertionError(f"{name} {algorithm}: {res.n_iterations} iterations != {n_iter}")
            report[f"{name}/{algorithm}"] = {"concepts": res.n_concepts,
                                             "iterations": res.n_iterations,
                                             "wall_s": wall}
    emit({"phase": "full_lattice", "runs": report})
    return report


def int32_ops_per_s(device) -> float:
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * INT32_OPS_PER_CLK_PER_SM * mhz * 1e6


def needed_word_ops(rows, cands, kw: dict | None) -> int:
    """Word operations these inputs need: the subset test up to each
    (candidate, row)'s first failing word (AND + compare per word), the
    match count per (candidate, row), the AND-accumulate of every word of
    every matching row, and, for K2 (``kw`` given), ~3 operations per
    closure word for the mask and the support test, and 3 more for CbO's
    canonicity test."""
    import torch

    test = 0
    acc = 0
    B, N = cands.shape[0], rows.shape[0]
    W = rows.shape[1]
    step = max(1, (1 << 24) // max(1, N * W))
    for lo in range(0, B, step):
        c = cands[lo: lo + step]
        ok = (rows[None, :, :] & c[:, None, :]) == c[:, None, :]  # [b, N, W]
        fail = ~ok
        first_fail = torch.where(fail.any(-1), fail.int().argmax(-1) + 1, W)
        test += int(first_fail.sum())
        acc += int(ok.all(-1).sum()) * W
    epilogue = 0 if kw is None else (6 if kw.get("cbo") else 3) * B * W
    return 2 * test + B * N + acc + epilogue


def moved_bytes(rows, cands, kw: dict | None) -> int:
    """Each input read once and each output written once."""
    (N, W), B = rows.shape, cands.shape[0]
    nbytes = (N * W + B * W) * 4 + B * (W + 1) * 4  # rows, cands; closures, supports
    if kw is not None:
        nbytes += W * 4 + 4 * 4 + B  # mask, scalars; keep
        if kw.get("cbo"):
            nbytes += 2 * B * W * 4  # parent, lowrow
    return nbytes


def time_kernels(device, launches: dict, chunks: dict) -> list[dict]:
    """Phase 6: each kernel on the chunks the main path gave it (captured
    in phase 4), beside its plain version and its bound.

    Every captured chunk is replayed and timed alone (CUDA events, median
    of TIMING_REPS after warm-up); ``run_ms`` and ``run_bound_ms`` are the
    sums over all of a kernel's launches in the phase-4 runs, and ``ms``,
    ``plain_ms`` and ``bound_ms`` are those of its costliest chunk."""
    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as k2

    rate = int32_ops_per_s(device)
    wrappers = {
        "closure": (k1.closure, k1.closure_plain, "src/repro_torch/csrc/closure.cu",
                    "src/repro/kernels/closure.py:99"),
        "fused_step": (k2.fused_step, k2.fused_step_plain, "src/repro_torch/csrc/frontier.cu",
                       "src/repro/kernels/frontier.py:173"),
    }
    out = []
    for name, (kern, plain, source, replaces) in wrappers.items():
        timed = []
        for algorithm, args, kw in chunks[name]:
            rows, cands = args[0], args[1]
            epi = kw if name == "fused_step" else None
            ms = cuda_time_ms(lambda: kern(*args, **kw))
            t_ops = needed_word_ops(rows, cands, epi) / rate * 1e3
            t_bytes = moved_bytes(rows, cands, epi) / HBM_BYTES_PER_S * 1e3
            timed.append((ms, t_ops, t_bytes, algorithm, args, kw))
        ms, t_ops, t_bytes, algorithm, args, kw = max(timed, key=lambda t: t[0])
        err = require_equal(f"{name} on its costliest main-path chunk",
                            kern(*args, **kw), plain(*args, **kw))
        plain_ms = cuda_time_ms(lambda: plain(*args, **kw))
        rows, cands = args[0], args[1]
        B, (N, W) = cands.shape[0], rows.shape
        census = 4 * B * N * W + B * N + (3 * B * W if name == "fused_step" else 0)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "chunk": {"algorithm": algorithm, "B": B, "N": N, "W": W,
                      "variant": {k: v for k, v in kw.items() if isinstance(v, bool)},
                      "scalars": list(args[3]) if name == "fused_step" else None},
            "census_bound_ms": max(census / rate * 1e3, t_bytes),
            "run_launches": len(timed),
            "run_ms": sum(t[0] for t in timed),
            "run_bound_ms": sum(max(t[1], t[2]) for t in timed),
            "run_ms_by_algorithm": {
                a: sum(t[0] for t in timed if t[3] == a) for a in MAIN_EXPECTED
            },
            "int32_ops_per_s": rate,
        })
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": {k: v["seconds"] for k, v in built.items()}})
    for name, rec in built.items():
        print(f"ptxas {name}: {rec['ptxas']}", flush=True)

    t0 = time.perf_counter()
    records = check_kernels(device)
    emit({"phase": "kernels", "cases": len(records), "seconds": time.perf_counter() - t0,
          "bit_exact": True})

    _, launches, chunks = run_main_path(device)
    run_full_lattices(device)
    emit({"kernels": time_kernels(device, launches, chunks)})

    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
