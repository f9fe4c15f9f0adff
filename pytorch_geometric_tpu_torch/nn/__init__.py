"""Neural-network layers."""
