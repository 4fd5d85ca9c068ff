"""Probes of the port on the card: the counterparts of the JAX package's
``tools/`` scripts, one module each, run as
``python -m f1tenth_gym_tpu_torch.tools.<name>``.

Each keeps its JAX counterpart's environment knobs and arguments, runs on
the card unless given ``--device cpu``, and has a ``main(argv=None)``
beside functions that return its numbers as a dict. ``culling_stats`` and
``rect_tier_estimate`` are host-only and run on the CPU by default;
``kernel_phases`` times the CUDA kernel and needs the card.
"""
