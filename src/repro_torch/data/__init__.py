from .synthetic import SyntheticConfig, batch_for_step, prefetch_batches

__all__ = ["SyntheticConfig", "batch_for_step", "prefetch_batches"]
