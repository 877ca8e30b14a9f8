"""Synthetic inputs for the port's workloads."""
