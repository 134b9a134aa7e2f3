"""Constant tables and host-facing helpers of the port (pure numpy, or thin
wrappers over the device ops)."""
