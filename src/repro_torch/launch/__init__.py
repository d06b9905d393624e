"""Launchers of the port (counterpart of ``repro/launch``): the
FELARE-routed serving runtime (``serve``) and the elastic federation
(``elastic``)."""
