"""Typed env configs."""
