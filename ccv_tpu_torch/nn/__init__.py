"""Neural-network ops, layers, the Sequential model, SQLite checkpoints and
optimizers of the port (counterpart of ``ccv_tpu.nn``, whose names it
re-exports in ``__all__``), and ``autotune``, the measured choice between
forms of an op."""

from ccv_tpu_torch.nn import ops, layers, model, optimizers, autotune

__all__ = ["ops", "layers", "model", "optimizers"]
