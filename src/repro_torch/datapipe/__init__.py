"""Synthetic data for the port (counterpart of ``repro/datapipe``): the
LM token stream of the training loop and the scheduling traces of the
sweep."""
