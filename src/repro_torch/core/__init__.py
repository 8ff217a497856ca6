"""Core numerics: the dual-mode unit's int path and the activations."""
