"""PyTorch port of the ``repro`` serving stack for NVIDIA Hopper (sm_90a).

LM serving of dense GQA, Mamba-2 (SSM) and hybrid stacks (config, model,
engine, continuous batcher, launcher) with hand-written CUDA kernels for
RMSNorm, flash prefill attention, decode attention and the SSD chunked
scan, and a W8A8 int8 matmul kernel, driven by an own copy of the numpy
request-lifecycle runtime (``core``, ``power``, ``runtime``,
``workloads``); training (``training``, ``launch.train``); and the fleet
simulator (``fleet``, with ``obs``), whose third engine,
``Fleet(backend="torch")``, and batched ``fleet.sweep`` step the whole
fleet as float64 tensors on the card. The package imports torch, numpy
and the standard library only; the JAX package ``repro`` is its reference
and is never imported from here.
"""
