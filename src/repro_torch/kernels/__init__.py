"""The port's kernels: CUDA sources in ``csrc/``, one wrapper module per
kernel, their plain PyTorch versions in ``ref``, and the device dispatch
in ``ops``."""
