"""Runtime helpers of the port (counterpart of ``repro.runtime``):
``elastic``'s shrink plans and ``fault_tolerance``'s training supervisor,
replayable batch stream and straggler detector.  The device mesh and its
sharding rules are a later slice (ROADMAP §1 item 12)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticPlan, plan_elastic, plan_serve_shrink)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    DeviceFailure, ReplayableIterator, StragglerDetector, Supervisor)
