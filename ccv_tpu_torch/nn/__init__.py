"""Neural-network ops, layers, the Sequential model, SQLite checkpoints and
optimizers of the port (counterpart of ``ccv_tpu.nn``, whose names it
re-exports)."""

from ccv_tpu_torch.nn import ops, layers, model, optimizers

__all__ = ["ops", "layers", "model", "optimizers"]
