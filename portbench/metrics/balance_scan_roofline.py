"""``balance_scan``'s share of its roofline (%), from the traced window's
device records and the frozen cost rule at the cell's shapes."""
from portbench.costs import balance_scan
from portbench.costs.roofline import kernel_share


def read(obs):
    return kernel_share(obs, "balance_scan", balance_scan.cost)
