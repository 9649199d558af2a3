"""Runtime helpers of the port (counterpart of ``repro.runtime``): the
sharding rules of the mesh, ``elastic``'s shrink plans and mesh,
``fault_tolerance``'s training supervisor, replayable batch stream and
straggler detector, and training on a mesh: the GPipe pipeline
(``pipeline_parallel``) and the data-parallel step with int8
error-feedback compression (``dp_step``)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticPlan, make_elastic_mesh, plan_elastic, plan_serve_shrink)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    DeviceFailure, ReplayableIterator, StragglerDetector, Supervisor)
from repro_torch.runtime.sharding import (  # noqa: F401
    batch_shardings, batch_spec, cache_specs, data_axes, named,
    opt_state_specs, param_shardings, param_specs, spec_for_param)
from repro_torch.runtime.pipeline_parallel import (  # noqa: F401
    pipeline_apply, stack_stages)
from repro_torch.runtime.dp_step import (  # noqa: F401
    init_dp_state, local_batch, make_compressed_dp_step)
