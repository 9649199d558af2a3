"""Hand-written Hopper kernels of the port (counterpart of
``repro.kernels``), all in CUDA C++ (``csrc/``, built by ``build.py``):
``paged_attention`` / ``paged_prefill_attention``, ``demux_rsa``,
``decode_attention``, ``flash_attention``, ``rwkv6``, and the Gaussian
mux entry's ``mux_embed_combine`` and ``mux_combine`` (one source,
``csrc/mux_entry.cu``).  Each has a plain PyTorch version beside it
(collected in ``ref.py``) and a counted dispatching wrapper in
``ops.py``."""
