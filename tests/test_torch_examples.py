"""The port's FCA examples (``examples/quickstart_torch.py``,
``fca_mining_torch.py``, ``fca_query_service_torch.py``) against the
reference examples of the same stem, on the CPU.

Each pair runs at the same arguments (the mining and query-service
examples at a smaller scale than their defaults, to keep the CPU time);
the port's through ``backend="kernel"`` (the plain versions here), the
reference's under the jax binding of ``tests/_torch_reference.py`` with
its engines at ``backend="jnp"``.  Their printed lines — concept counts,
rounds, modeled bytes, hit rates, collective rounds, top-k supports, the
streamed lattice's growth and the remine check — must be equal once wall
times and rates are masked (chip_smoke.py's ``example_lines``, the same
comparison its phase 22c makes against ``EXAMPLES_EXPECTED``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import sys

import pytest

from _torch_reference import jax_reference, run_reference_example  # noqa: F401
from test_torch_collectives import ROOT

sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

CASES = {
    "quickstart": {},
    "fca_mining": {"dataset": "mushroom", "scale": 0.003, "parts": (1, 4)},
    "fca_query_service": {"dataset": "mushroom", "scale": 0.003, "parts": 4,
                          "reduce_impl": "auto", "queries": 64, "updates": 6},
}


def port_example(stem: str):
    spec = importlib.util.spec_from_file_location(
        f"port_example_{stem}", ROOT / "examples" / f"{stem}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(stem: str, **kwargs) -> tuple[list, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = port_example(stem).main(device="cpu", **kwargs)
    return cs.example_lines(buf.getvalue()), out


@pytest.mark.parametrize("stem", list(CASES))
def test_example_prints_the_references_lines(stem, jax_reference):
    lines, out = run_port(stem, **CASES[stem])
    assert lines == run_reference_example(stem, **CASES[stem])
    if stem == "quickstart":
        assert out["nextclosure"] == out["lattice"] == 21
        assert {k: (v["concepts"], v["rounds"], v["match"]) for k, v in out["drivers"].items()} \
            == {"MRGanter": (21, 21, True), "MRGanter+": (21, 5, True),
                "MRCbo": (21, 5, True)}
    elif stem == "fca_mining":
        assert all(r["match"] and r["concepts"] == out["nextclosure"]
                   for r in out["runs"].values())
        assert out["runs"][(1, "rsag")]["comm_bytes"] == 0
    else:
        assert out["remine_equal"] and out["concepts_after"] > out["concepts_before"]


def test_chip_smoke_example_arguments_are_the_examples():
    """Phase 22c's arguments name each example's own parameters."""
    import inspect

    for stem, kwargs in cs.EXAMPLE_ARGS.items():
        params = inspect.signature(port_example(stem[: -len("_torch")]).main).parameters
        assert set(kwargs) <= set(params) and "device" in params, stem
        assert set(cs.EXAMPLE_KERNELS[stem]) <= {"closure", "fused_step", "map_closure",
                                                 "filter_step", "contains_topk"}
