"""Hand-written CUDA kernels for the hot spots, with their plain versions.

Layout per kernel, mirroring ``repro.kernels``: ``ref.py`` (the plain
PyTorch version), ``<name>.py`` (the ctypes binding of the CUDA source in
``repro_torch/csrc/``), ``ops.py`` (the public op: checks its inputs, runs
the plain version for a CPU tensor and launches the kernel for a CUDA
tensor, counting launches).

The four kernels of the reference:

- ``distance`` -- batched l2 / ip distance matrix (``csrc/distance.cu``).
- ``topk``     -- k smallest per row, ties to the lowest index
  (``csrc/topk.cu``).
- ``qdist``    -- fp query vs int8 rows with per-row scales, all pairs
  and the IVF cell scan (``csrc/qdist.cu``); its quantizer
  (``ops.quantize_int8``) is plain PyTorch, as the reference's is plain
  jnp.
- ``flash``    -- causal GQA attention forward with optional sliding
  window and softcap, the policy LM's prefill (``csrc/flash.cu``).
"""
