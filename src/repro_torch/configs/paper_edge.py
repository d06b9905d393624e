"""The paper's own workload: the 4x4 synthetic HEC system (Table I) plus the
AWS scenario, as a 'config' (counterpart of ``repro/configs/paper_edge.py``).

Systems and workload scenarios both resolve through the
:mod:`repro_torch.scenarios` registries; the constants below are the
paper's operating points.
"""
from repro_torch import scenarios
from repro_torch.core import api

SYSTEM = api.paper_system()
AWS = api.aws_system()

#: The Sec. VI-A workload recipe (stationary Poisson / uniform mix /
#: Eq. 4 deadlines / Gamma runtimes) — ``SweepSpec``'s default.
SCENARIO = scenarios.get("poisson")

#: Beyond-paper stress workloads registered out of the box.
STRESS_SCENARIOS = tuple(
    name for name in scenarios.list_scenarios() if name != "poisson"
)
