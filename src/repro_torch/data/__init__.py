from .pipeline import SyntheticLM, host_slice
