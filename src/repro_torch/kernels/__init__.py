"""Hand-written Hopper kernels of the port (counterpart of
``repro.kernels``): ``paged_attention`` / ``paged_prefill_attention``,
``demux_rsa``, ``decode_attention``, ``flash_attention`` and ``rwkv6``
in CUDA C++ (``csrc/``, built by ``build.py``), and
``mux_embed_combine`` and ``mux_combine`` in Triton.
Each has a plain PyTorch version beside it (collected in ``ref.py``) and a
counted dispatching wrapper in ``ops.py``."""
