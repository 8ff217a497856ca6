"""Architecture configs of the port.  ``base.py`` and the per-arch
modules are copies of the reference's framework-free files (held equal
to them by tests/test_torch_model.py)."""
from .base import LayerSpec, ModelConfig  # noqa: F401
from .registry import ARCH_IDS, get_config, reduced_config  # noqa: F401
