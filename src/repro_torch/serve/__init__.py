"""Serving stack of the port (counterpart of ``repro.serve``): paged KV
pool (``kvpool``), engine steps over a ring or paged cache (``engine``),
sampling, the fill-drain ``batcher.MuxBatcher``, the continuous scheduler
and the plan-executing ``runtime.ServeRuntime``:

    sc = ServeConfig(cfg, MuxSpec(n=2), capacity=256, cache_layout="paged")
    rt = ServeRuntime(params, sc, backbone_rows=4, chunk=32)   # on cuda
    rt.submit(Request(uid=0, prompt=toks, max_new=16))
    while rt.has_work():
        rt.step()

The package imports no submodule itself (``models`` imports ``kvpool``,
and ``engine`` imports ``models``).
"""
