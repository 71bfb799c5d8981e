"""Training: DiSMEC's streaming label-batch engine (`xmc`) and the LM
trainer (`trainer`)."""
