"""Kernels of the port: plain PyTorch versions (:mod:`.ref`), hand-written
CUDA kernels for Hopper (``csrc/``, wrapped by :mod:`.flash_attention`,
:mod:`.decode_attention`, :mod:`.mamba_chunk_scan` and :mod:`.rmsnorm`)
and the dispatcher the model calls (:mod:`.ops`), which wires the flash
attention and RMSNorm kernels into autograd."""
