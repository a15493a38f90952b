"""Adapters at the NumPy boundary: the old-Gym single env (gym_api), its
Gymnasium facade (gymnasium_api), the SB3-style VecEnv over the batched
engine (vector_env), and the JAX package's option names (options)."""
