"""Parity runtimes of the port: the native C++ host physics (parity/native.py)."""
