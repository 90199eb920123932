"""Hand-written CUDA kernels of the port, their plain PyTorch versions,
and the device dispatch between them (:mod:`.ops`)."""
