"""Neural-network layers of the LM families (dense transformer so far)."""
