"""Plain fp32 references of the benchmark's models and optimizer.

They import torch and numpy only, nothing of the program under test, and
read the benchmark's own weights (a tree in the port's layout) and the
configuration's ``model`` block.  TF32 is switched off by
:func:`exact_fp32`.
"""
