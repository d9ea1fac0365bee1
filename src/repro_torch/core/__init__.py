"""Solvers (``krylov``) and the stochastic performance model (``perfmodel``)."""
