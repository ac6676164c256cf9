"""Local prox-SGD solvers."""
