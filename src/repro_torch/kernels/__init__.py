"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, plus the schedule (``plan``) and the oracles (``ref``)."""
