"""Model hyper-parameter records of the port."""
