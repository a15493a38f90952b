"""Dynamics constants, tableaux and the kernel wrappers (with plain twins)."""
