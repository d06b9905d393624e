"""``map_decide``'s share of its roofline (%), from the traced window's
device records and the frozen cost rule at the cell's shapes."""
from portbench.costs import map_decide
from portbench.costs.roofline import kernel_share


def read(obs):
    return kernel_share(obs, "map_decide", map_decide.cost)
