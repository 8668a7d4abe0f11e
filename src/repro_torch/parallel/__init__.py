"""Parallelism of the port (the port of :mod:`repro.parallel`): the int8
error-feedback compression of the data-parallel step's inter-node leg, and
:mod:`.sharding`, the logical-axis rules as DTensor placements (imported
from its module: it loads ``torch.distributed.tensor``)."""

from .compression import dequant_int8, ef_compressed_psum, init_ef_state, quant_int8, wire_bytes_per_param

__all__ = ["dequant_int8", "ef_compressed_psum", "init_ef_state", "quant_int8", "wire_bytes_per_param"]
