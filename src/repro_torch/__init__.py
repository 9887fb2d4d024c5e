"""PyTorch/CUDA port of the :mod:`repro` model, serving and training
layers.

The package mirrors ``src/repro/`` module for module and keeps the same
nested-dict parameter trees, so params move between the two packages
leaf by leaf (:mod:`repro_torch.bridge`) and checkpoints share their
on-disk layout (:mod:`repro_torch.ckpt.checkpoint`).  It imports torch,
numpy and the standard library only.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; on the card attention and
RMSNorm, forward and backward, go through the hand-written kernels in
:mod:`repro_torch.kernels`.
"""
