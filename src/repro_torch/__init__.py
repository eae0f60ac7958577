"""repro_torch — the PyTorch + CUDA counterpart of ``repro``.

This slice runs the mining main path on one object shard with synchronous
rounds: ``FormalContext`` → ``ClosureEngine`` → ``DeviceFrontier`` → the
``mrganter`` / ``mrganter_plus`` / ``mrcbo`` drivers.  The two kernels on
that path are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use and bound through ``ctypes``; each has a plain
PyTorch version beside it that runs for CPU tensors.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back.
"""
