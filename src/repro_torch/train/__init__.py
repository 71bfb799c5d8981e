"""DiSMEC's streaming label-batch training engine."""
