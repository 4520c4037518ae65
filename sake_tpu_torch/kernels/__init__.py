"""Functional model, weight layout and the resid_ef kernels (K1/K2)."""
