from .store import CheckpointStore, latest_step
