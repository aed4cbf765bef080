"""Cascade training tools of the port (counterpart of ``ccv_tpu.train``;
reference: bin/*create and the trainer halves of lib/ccv_scd.c and
ccv_icf.c). ``scd``: SCD cascades by gentle AdaBoost over logistic SURF
stumps; ``icf``: ICF soft cascades of depth-2 trees."""
