"""The plain reference that decides ``correct``: NumPy and plain PyTorch,
importing nothing of ``hpbandster_tpu_torch`` or of the JAX package.

Each module is a frozen copy of one rule of the port, and names the port
file it was copied from, so a later change to the port does not move the
yardstick.
"""
