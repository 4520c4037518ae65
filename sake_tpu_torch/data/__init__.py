"""Datasets (numpy)."""
