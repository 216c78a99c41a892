"""PyTorch port of the ``repro`` serving stack for NVIDIA Hopper (sm_90a).

Dense GQA LM serving (config, model, engine, continuous batcher, launcher)
with hand-written CUDA kernels for RMSNorm, flash prefill attention and
decode attention. The package imports torch, numpy and the standard
library only; the JAX package ``repro`` is its reference and is never
imported from here.
"""
