"""Click and full-res programs of the port, their captured form on the
card, and the interactive, streaming and batch engines."""
