"""Serving engine of the port (paged mode)."""
from .engine import Request, ServeEngine, sample_token  # noqa: F401
from .paged_cache import BlockPool, chain_hashes  # noqa: F401
