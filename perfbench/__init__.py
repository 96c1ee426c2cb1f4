"""The benchmark of the PyTorch and CUDA port (``nbasr_torch``) on an H100."""
