"""nbasr_torch: the NAS-Bench-ASR encoder on PyTorch and CUDA (NVIDIA Hopper).

A port of ``nbasr_tpu`` that imports nothing of JAX or of that package.
``models.get_model`` builds the encoder on a device; ``serving.StreamingASR``
streams audio through it; ``training.Trainer`` (and ``python -m
nbasr_torch.train``, the twin of ``train.py``) trains it and evaluates it
with the beam-search decoder.  Every SearchCell runs the hand-written CUDA
kernels in ``csrc/fused_cell.cu`` (forward, with dropout) and
``csrc/fused_cell_bwd.cu`` (backward), or those of ``csrc/grouped_conv.cu``
on the unfused paths, and the CTC loss its recursions in ``csrc/ctc.cu``,
on the card.  Entry points default to ``device='cuda'``; the CPU runs only
when asked for, and there the kernels' plain PyTorch versions stand in.
"""

__version__ = '0.1.0'
