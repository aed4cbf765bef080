"""Detector training tools of the port (counterpart of ``ccv_tpu.train``;
reference: bin/*create and the trainer halves of lib/ccv_scd.c, ccv_icf.c,
ccv_bbf.c, ccv_dpm.c and bin/swtcreate.c). ``scd``: SCD cascades by gentle
AdaBoost over logistic SURF stumps; ``icf``: ICF soft cascades of depth-2
trees; ``bbf``: BBF cascades by a genetic feature search and AdaBoost;
``swt``: the SWT parameter search on the Wolf-Jolion score; ``dpm``: DPM
mixture models by a latent SVM with hard-negative mining."""

from ccv_tpu_torch.train import bbf, dpm, icf, scd, swt

__all__ = ["bbf", "dpm", "icf", "scd", "swt"]
