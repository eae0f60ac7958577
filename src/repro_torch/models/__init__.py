"""The port's decoder stack: attention, Griffin, Mamba-2 and MoE layers."""
