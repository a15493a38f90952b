"""Hexagonal tiling: static geometry and the batched reset sampler."""
