"""Click and full-res programs of the port."""
