"""The reference's ``data`` package on the port (``from data import
colorize_image as CI``, ``from data import lab_gamut``): see the drop-in
root's docstring, ``ideepcolor_tpu_torch/compat/__init__.py``."""
