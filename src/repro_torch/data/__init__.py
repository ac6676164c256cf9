"""Synthetic federated datasets and their stacked container (numpy)."""
