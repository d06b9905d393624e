"""The serving front (counterpart of ``repro/cluster``): machine profiles
and the FELARE request router."""
