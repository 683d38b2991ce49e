"""Utilities of the port: label maps, the native boundary matcher's build
and loading, visualisation and the HDF5 feature cache (``utils.cache``)."""
