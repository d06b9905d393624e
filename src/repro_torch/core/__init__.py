"""Core of the port: types, equations, policies and the batched engine."""
