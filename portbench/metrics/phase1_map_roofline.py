"""``phase1_map``'s share of its roofline (%), from the traced window's
device records and the frozen cost rule at the cell's shapes."""
from portbench.costs import phase1_map
from portbench.costs.roofline import kernel_share


def read(obs):
    return kernel_share(obs, "phase1_map", phase1_map.cost)
