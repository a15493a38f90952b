"""Parity runtimes of the port: the native C++ host physics (parity/native.py)
and the device parity tier (parity/device_replay.py: the golden episodes
replayed bit for bit through the batched engine, on the numpy-exact ops of
ops/exact.py and the sequential-exact tiling twin tiling/device_exact.py)."""
