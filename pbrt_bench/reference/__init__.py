"""The benchmark's plain reference of the path tracer.

Plain PyTorch and NumPy, in float32 (or a lower precision for the control).
It imports nothing of the port and nothing of the JAX package, and derives
every table it needs (world triangles, per-instance bounds) from the
benchmark's own scene inputs. Its shading is a frozen copy of the
renderer's math for the configurations the benchmark runs (the default
BRDF, untextured models, stochastic NEE with one shadow ray, no sky); its
intersection is its own: per-instance bounds, then brute force over each
instance's triangles.
"""
