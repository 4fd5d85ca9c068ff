"""The port's version: the JAX package's (``f1tenth_gym_tpu/version.py``)."""

__version__ = "0.1.0"
