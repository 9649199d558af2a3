"""Runtime helpers of the port (counterpart of ``repro.runtime``): the
serve half only — ``elastic``'s shrink plans and ``fault_tolerance``'s
straggler detector.  Training's supervisor, the device mesh and its
sharding rules are later slices (ROADMAP §1 items 12-13)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticPlan, plan_elastic, plan_serve_shrink)
from repro_torch.runtime.fault_tolerance import StragglerDetector  # noqa: F401
