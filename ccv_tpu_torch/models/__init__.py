"""Model families of the port (counterpart of ``ccv_tpu.models``)."""
