"""Synthetic data for the port (counterpart of ``repro/datapipe``)."""
