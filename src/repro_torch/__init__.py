"""PyTorch/CUDA port of the CRINN ANNS engine (``repro``), for an NVIDIA
H100.

The module paths mirror the JAX package (``repro/anns/search.py`` <->
``repro_torch/anns/search.py``).  The package imports ``torch`` and
numpy only.  Every entry point takes a ``device`` and runs on ``cuda``
unless the caller asks for ``"cpu"``; with no card and no such request it
raises instead of carrying on on the CPU.

The two hand-written CUDA kernels (``csrc/distance.cu``, ``csrc/topk.cu``)
are built with nvcc at first use (:mod:`repro_torch.kernels._build`).  On a
CPU tensor each op runs its plain PyTorch version instead.
"""
