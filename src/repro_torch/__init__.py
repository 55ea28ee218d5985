"""PyTorch/CUDA port of CRINN (``repro``) for an NVIDIA H100: the ANNS
engine and server, and the contrastive-RL loop that tunes it with a
GRPO-trained policy LM.

The module paths mirror the JAX package (``repro/anns/search.py`` <->
``repro_torch/anns/search.py``).  The package imports ``torch`` and
numpy only.  Every entry point takes a ``device`` and runs on ``cuda``
unless the caller asks for ``"cpu"``; with no card and no such request it
raises instead of carrying on on the CPU.

The hand-written CUDA kernels (``csrc/distance.cu``, ``csrc/topk.cu``,
``csrc/flash.cu``) are built with nvcc at first use
(:mod:`repro_torch.kernels._build`).  On a CPU tensor each op runs its
plain PyTorch version instead.
"""
