from .fault_tolerance import CheckpointManager, run_with_recovery

__all__ = ["CheckpointManager", "run_with_recovery"]
