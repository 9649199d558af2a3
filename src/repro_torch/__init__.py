"""PyTorch port of the MUX-PLMs serving system, for one NVIDIA Hopper card.

Mirrors the module layout of the JAX package ``repro`` (the reference):
``nn``, ``core``, ``kernels``, ``models``, ``configs``, ``serve``,
``launch``.  It serves a decoder-only ``TransformerLM`` with a Gaussian
mux and an RSA demux in the reference's serving modes — fill-drain and
continuous over a ring cache, continuous over paged KV with chunked or
blocking prefill — through eight hand-written CUDA kernels (``kernels/``).
Weights and caches cross over from the reference through ``interop``.

The package imports ``torch`` and numpy only; the CUDA kernels are built
at first launch (``kernels/build.py``), so importing it needs no
``nvcc``.
"""
