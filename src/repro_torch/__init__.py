"""PyTorch port of the MUX-PLMs serving system, for one NVIDIA Hopper card.

Mirrors the module layout of the JAX package ``repro`` (the reference):
``nn``, ``core``, ``kernels``, ``models``, ``configs``, ``serve``,
``launch``.  This slice carries the main path — continuous paged serving
of a decoder-only ``TransformerLM`` with a Gaussian mux and an RSA demux —
through four hand-written kernels (``kernels/``).  Weights cross over from
the reference through ``interop``.

The package imports ``torch`` and numpy only; Triton and the CUDA kernels
are built at first launch (``kernels/build.py``), so importing it needs
neither ``triton`` nor ``nvcc``.
"""
