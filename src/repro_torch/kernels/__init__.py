"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``closure.closure`` (K1, ``csrc/closure.cu``) and ``frontier.fused_step``
(K2, ``csrc/frontier.cu``) launch their kernel for CUDA tensors and run
their plain version (``closure_plain`` / ``fused_step_plain``) for CPU
tensors.  Each wrapper counts its launches in a plain ``launches``
attribute.
"""

from repro_torch.kernels import closure as _k1
from repro_torch.kernels import frontier as _k2

KERNELS = (_k1.closure, _k2.fused_step)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
