"""The JAX package's ``examples/`` on the port, each run with ``python -m
f1tenth_gym_tpu_torch.examples.<name>`` and taking ``--device``."""
