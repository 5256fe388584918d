"""Utilities of the port shared by the model zoo and the datasets."""
