"""Ops of the port: frontend, fused cell kernel, decoding."""
