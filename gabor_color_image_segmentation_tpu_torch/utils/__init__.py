"""Utilities of the port: label alignment for parity checks."""
