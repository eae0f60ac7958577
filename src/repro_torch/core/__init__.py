"""Core: the paper's contribution — centralized and distributed FCA."""

from repro_torch.core.closebyone import CbOResult, close_by_one
from repro_torch.core.context import FormalContext, paper_context
from repro_torch.core.engine import ClosureEngine
from repro_torch.core.frontier import DeviceFrontier
from repro_torch.core.hashindex import TwoLevelHash
from repro_torch.core.mr import MRResult, mrcbo, mrganter, mrganter_plus
from repro_torch.core.nextclosure import (
    all_closures,
    all_closures_batched,
    first_closure,
    next_closure,
)

__all__ = [
    "FormalContext",
    "paper_context",
    "ClosureEngine",
    "DeviceFrontier",
    "MRResult",
    "mrganter",
    "mrganter_plus",
    "mrcbo",
    "all_closures",
    "all_closures_batched",
    "first_closure",
    "next_closure",
    "CbOResult",
    "close_by_one",
    "TwoLevelHash",
]
