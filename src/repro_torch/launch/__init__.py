"""Launchers of the port (counterpart of ``repro/launch``): the
FELARE-routed serving runtime (``serve``), the elastic federation
(``elastic``), training on one device or a mesh (``train``), and the
process groups and device meshes (``mesh``)."""
