"""PyTorch and CUDA port of the JAX model stack in :mod:`repro`, for an NVIDIA
H100.

It imports ``torch``, ``numpy`` and the standard library only: nothing of JAX
and nothing of the ``repro`` package, whose modules it keeps its own copies of
where it needs them. The JAX package stays the reference that the tests hold
this package against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
card, attention and norms go through the hand-written kernels in
:mod:`repro_torch.kernels`, on the CPU through their plain versions.
"""
