"""Attention kernels of the port: plain PyTorch versions (:mod:`.ref`),
hand-written CUDA kernels for Hopper (``csrc/``, wrapped by
:mod:`.flash_attention` and :mod:`.decode_attention`) and the dispatcher
the model calls (:mod:`.ops`)."""
