"""The port's decoder stack (attention-only, dense, token-input archs)."""
