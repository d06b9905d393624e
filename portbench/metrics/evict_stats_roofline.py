"""``evict_stats``'s share of its roofline (%), from the traced window's
device records and the frozen cost rule at the cell's shapes."""
from portbench.costs import evict_stats
from portbench.costs.roofline import kernel_share


def read(obs):
    return kernel_share(obs, "evict_stats", evict_stats.cost)
