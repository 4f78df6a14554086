"""PyTorch/CUDA port of the BLS DLRM serving system and of its LM serving
path (dense LMs and rwkv6).

Mirrors the layout of the JAX reference package ``repro`` module by module.
It imports ``torch``, ``numpy`` and the standard library only.  The
embedding bags, the dot interaction, flash attention and the RWKV-6 WKV run
through hand-written CUDA kernels for Hopper (``kernels/csrc``), built with
``nvcc`` at first use.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""
