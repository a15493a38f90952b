"""Host-side renderer of the old-Gym adapter (compat/gym_api.py)."""
