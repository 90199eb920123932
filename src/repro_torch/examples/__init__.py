"""Runnable examples of the port, each the counterpart of a script in the
repository's ``examples/`` directory:

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.sequence_labeling
    python -m repro_torch.examples.segmentation_distributed
    python -m repro_torch.examples.ssvm_head
    python -m repro_torch.examples.lm_train

Each runs on CUDA by default (``--device cpu`` for the plain PyTorch
path), and its ``main(argv=None)`` returns the figures it prints.
"""
