"""Synthetic data and parity helpers for the port's tests and smoke run."""
