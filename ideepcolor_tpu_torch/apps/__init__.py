"""Entry points over the port's API classes."""
