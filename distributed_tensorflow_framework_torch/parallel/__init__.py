"""Explicit collectives over the ranks of a process group: the gradient
all-reduce with its bf16 and int8 error-feedback wires (collectives.py)
and the block-scaled int8 codec (quantization.py)."""
