"""Run statistics of the port.  Spans, histograms and the metrics
registry come with the observability slice."""

from repro_torch.obs.stats import StatsBase

__all__ = ["StatsBase"]
