"""Neural-network layers of the port: the causal conv block and the grouped GRU."""
