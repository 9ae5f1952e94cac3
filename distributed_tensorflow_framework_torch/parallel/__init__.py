"""Explicit collectives over the ranks of a process group: the gradient
all-reduce with its bf16 and int8 error-feedback wires (collectives.py)
and the block-scaled int8 codec (quantization.py); ZeRO (zero.py), the
FSDP and tensor-parallel layouts (sharding.py, tensor_parallel.py) and
ring attention over the ``seq`` ranks (ring.py)."""
