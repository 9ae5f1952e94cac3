"""PyTorch/CUDA port of the distributed training framework.

Mirrors the subpackage layout of ``distributed_tensorflow_framework_tpu``
(core/, ckpt/, models/, ops/, serve/, cli/, train/) so each module's
counterpart is easy to find. It imports torch, numpy, yaml and the stdlib —
never JAX and nothing from the JAX package. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.

Ported so far: BERT MLM serving (config -> artifact -> engine -> HTTP
server) and BERT MLM training on one device (config -> synthetic MLM
stream -> train step with AdamW -> Trainer loop -> cli/train.py), with the
whole-K flash-attention forward and backward as hand-written CUDA kernels
(ops/csrc/flash_attn_fwd.cu, ops/csrc/flash_attn_bwd.cu). ROADMAP.md lists
what comes next.
"""
