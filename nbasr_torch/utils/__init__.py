"""Utilities of the port: the TensorBoard scalar writer."""
