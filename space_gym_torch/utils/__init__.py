"""Randomness plumbing, device selection and the CUDA build."""
