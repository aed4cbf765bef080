"""Neural-network ops, layers, the Sequential model, SQLite checkpoints and
optimizers of the port (counterpart of ``ccv_tpu.nn``)."""
