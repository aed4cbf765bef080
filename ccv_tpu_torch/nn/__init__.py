"""Neural-network ops and optimizers of the port (counterpart of
``ccv_tpu.nn``)."""
