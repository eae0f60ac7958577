"""repro_torch — the PyTorch + CUDA counterpart of ``repro``.

The mining main path runs over k object shards with synchronous rounds:
``FormalContext`` → ``ClosureEngine`` (over a ``ShardPlan``: k simulated
shards on one device, or one shard per rank of a ``torch.distributed``
group) → ``DeviceFrontier`` → the ``mrganter`` / ``mrganter_plus`` /
``mrcbo`` drivers.  The four kernels on that path (K1 closure, K2 fused
step, K3 multi-shard map, K4 multi-shard filter) are hand-written CUDA C++
for Hopper (``csrc/``), built with ``nvcc`` at first use and bound through
``ctypes``; each has a plain PyTorch version beside it that runs for CPU
tensors.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back.
"""
