"""nbasr_torch: the NAS-Bench-ASR encoder on PyTorch and CUDA (NVIDIA Hopper).

A port of ``nbasr_tpu`` that imports nothing of JAX or of that package.
This slice serves: ``models.get_model`` builds the encoder on a device,
``serving.StreamingASR`` streams audio through it, and every SearchCell runs
the hand-written CUDA kernel in ``csrc/fused_cell.cu`` on the card.  Entry
points default to ``device='cuda'``; the CPU runs only when asked for, and
there the kernels' plain PyTorch versions stand in.
"""

__version__ = '0.1.0'
