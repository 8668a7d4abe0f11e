"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the dispatch between them (:mod:`.ops`).

Sources are in ``csrc/``; :mod:`._build` compiles them at first use. Nothing
here compiles or loads a kernel at import time.
"""
