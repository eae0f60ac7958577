"""FCA datasets: the paper's UCI contexts or their offline stand-ins."""
