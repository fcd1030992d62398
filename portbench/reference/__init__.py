"""Plain Python reference of what a cell's timed path produces.

It rebuilds the circuit, the keys' secrets and every proof element from the
seed alone, in plain integer arithmetic, and imports nothing of the port
(zksnake_tpu_torch), of the JAX package or of jax.
"""
