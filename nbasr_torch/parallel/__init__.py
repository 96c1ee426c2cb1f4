"""Parallel runtime of the port (so far: the encoder's time halo)."""
