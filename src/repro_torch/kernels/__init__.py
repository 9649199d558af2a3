"""Hand-written Hopper kernels of the main path (counterpart of
``repro.kernels``): ``paged_attention`` / ``paged_prefill_attention`` and
``demux_rsa`` in CUDA C++ (``csrc/``, built by ``build.py``), and
``mux_embed_combine`` in Triton.  Each has a plain PyTorch version beside
it (collected in ``ref.py``) and a counted dispatching wrapper in
``ops.py``."""
