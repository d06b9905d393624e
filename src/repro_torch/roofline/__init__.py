"""The roofline of the port's programs on the H100 (counterpart of
``repro/roofline``).

  * :mod:`~repro_torch.roofline.hw` — the card's peak rates;
  * :mod:`~repro_torch.roofline.walk` — the visitor over every aten op a
    function runs, with the kernel wrappers' scope;
  * :mod:`~repro_torch.roofline.cost` — FLOPs and HBM bytes per rank
    (``cost.cost(fn, *args)``);
  * :mod:`~repro_torch.roofline.collectives` — collective bytes by kind;
  * :mod:`~repro_torch.roofline.analysis` — ``Roofline``,
    ``model_flops_for``, ``from_cost``, ``share``.

Importing it touches no device.
"""
