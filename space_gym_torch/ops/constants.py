"""Physical constants shared across the dynamics stack.

The gravitational constant is defined twice in the upstream Space-Gym with the
same value (gym_space/helpers.py:19, gym_space/planet.py:5); one definition.
"""

# Gravitational constant [m^3 kg^-1 s^-2] (gym_space/helpers.py:19).
G = 6.6743e-11
