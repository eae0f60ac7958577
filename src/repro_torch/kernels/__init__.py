"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

in ``csrc/frontier.cu``, ``closure.closure`` (K1),
``frontier.fused_step`` (K2), ``frontier.map_closure`` (K3) and
``frontier.filter_step`` (K4); in ``csrc/serve.cu``, ``serve.contains_topk``
(K5, the top-k query's contains-mask × support selection) and
``serve.rules_topk`` (K6, the rule query's premise test, consequent union
and metric selection).  Each launches its kernel for CUDA tensors and runs
its plain version (``closure_plain``, ``fused_step_plain``,
``map_closure_plain``, ``filter_step_plain``, ``contains_topk_plain``,
``rules_topk_plain``) for CPU tensors; in ``csrc/attention.cu``, K7
(flash attention, forward) behind two wrappers,
``flash_attention.flash_attention`` (the reference kernel's layout) and
``flash_attention.blockwise_attention`` (the model's layout, with
left-pad ``valid_from``), whose plain version is ``attention_plain``;
K7b (flash attention, backward: dq, dk and dv from K7's log-sum-exp),
``flash_attention.attention_backward``, whose plain version is autograd
through ``attention_plain`` (``attention_backward_plain``); a train-mode
``blockwise_attention`` on the card runs K7 then K7b through
``flash_attention._BlockwiseAttentionFn``.
Each wrapper counts its launches in a plain ``launches`` attribute; K1, K2
and K3 also count those that took their tensor-core body in ``tc_launches``.
K7's and K7b's launches are the custom operators ``repro_torch::k7_fwd``
and ``repro_torch::k7b_bwd``, with fake implementations and flop formulas.
"""

from repro_torch.kernels import closure as _k1
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import frontier as _fr
from repro_torch.kernels import serve as _sv

KERNELS = (_k1.closure, _fr.fused_step, _fr.map_closure, _fr.filter_step,
           _sv.contains_topk, _sv.rules_topk, _fa.flash_attention, _fa.blockwise_attention,
           _fa.attention_backward)


def reset_launches() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "tc_launches"):
            k.tc_launches = 0
