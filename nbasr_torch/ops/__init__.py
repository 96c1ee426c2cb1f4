"""Ops of the port: frontend, cell kernels, CTC loss and its kernels,
decoding."""
