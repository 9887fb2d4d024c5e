"""Kernels of the port: plain PyTorch versions (:mod:`.ref`), hand-written
CUDA kernels for Hopper (``csrc/``, wrapped by :mod:`.flash_attention`,
:mod:`.decode_attention` and :mod:`.mamba_chunk_scan`) and the dispatcher
the model calls (:mod:`.ops`)."""
