"""Launchers of the port (counterpart of ``repro/launch``): the
FELARE-routed serving runtime (``serve``), the elastic federation
(``elastic``) and single-device training (``train``)."""
