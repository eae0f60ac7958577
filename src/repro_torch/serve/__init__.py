"""Serving of the port: the FCA admission tier and LM serving.

``admission`` packs asynchronously arriving queries into the
``QueryEngine``'s fixed-slot micro-batches (deadline-or-full dispatch,
bounded depth); ``loadgen`` drives it open-loop at a target QPS.  The LM
``engine`` module (``ServeConfig``, ``ServeEngine``, ``GenerateStats``)
is loaded on first access through the module ``__getattr__``, so that
importing this package for the queue does not import the decoder.
"""

from repro_torch.serve.admission import (
    KINDS,
    AdmissionConfig,
    AdmissionQueue,
    ServeStats,
    Ticket,
)
from repro_torch.serve.loadgen import (
    ARRIVALS,
    DEFAULT_MIX,
    LoadReport,
    burst_arrivals,
    make_workload,
    poisson_arrivals,
    run_load,
)

_LM_NAMES = ("ServeConfig", "ServeEngine", "GenerateStats")

__all__ = [
    "KINDS",
    "AdmissionConfig",
    "AdmissionQueue",
    "ServeStats",
    "Ticket",
    "ARRIVALS",
    "DEFAULT_MIX",
    "LoadReport",
    "burst_arrivals",
    "make_workload",
    "poisson_arrivals",
    "run_load",
    *_LM_NAMES,
]


def __getattr__(name):
    if name in _LM_NAMES:
        from repro_torch.serve import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
