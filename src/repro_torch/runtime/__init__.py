"""Runtime helpers of the port (counterpart of ``repro.runtime``): the
sharding rules of the serve mesh, ``elastic``'s shrink plans and mesh,
and ``fault_tolerance``'s training supervisor, replayable batch stream
and straggler detector.  The data-parallel and pipeline-parallel training
steps (the reference's ``dp_step`` and ``pipeline_parallel``) are ROADMAP
§1 item 15."""
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticPlan, make_elastic_mesh, plan_elastic, plan_serve_shrink)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    DeviceFailure, ReplayableIterator, StragglerDetector, Supervisor)
from repro_torch.runtime.sharding import (  # noqa: F401
    batch_shardings, batch_spec, cache_specs, data_axes, named,
    opt_state_specs, param_shardings, param_specs, spec_for_param)
