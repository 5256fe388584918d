"""Config helpers shared by the port's models."""
