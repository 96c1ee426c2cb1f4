"""nbasr_torch: the NAS-Bench-ASR encoder on PyTorch and CUDA (NVIDIA Hopper).

A port of ``nbasr_tpu`` that imports nothing of JAX or of that package.
``models.get_model`` builds the encoder on a device; ``serving.StreamingASR``
streams audio through it; ``training.Trainer`` (and ``python -m
nbasr_torch.train``, the twin of ``train.py``) trains it.  Every SearchCell
runs the hand-written CUDA kernels in ``csrc/fused_cell.cu`` (forward, with
dropout) and ``csrc/fused_cell_bwd.cu`` (backward) on the card.  Entry
points default to ``device='cuda'``; the CPU runs only when asked for, and
there the kernels' plain PyTorch versions stand in.
"""

__version__ = '0.1.0'
