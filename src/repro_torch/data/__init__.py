"""Data generators of the port (numpy, framework-free)."""
