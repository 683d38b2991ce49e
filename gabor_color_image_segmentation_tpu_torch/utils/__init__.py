"""Utilities of the port: label maps, the native boundary matcher's build
and loading, and visualisation."""
