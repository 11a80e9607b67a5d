"""Kernels of the port: CUDA C++ for Hopper (``sm_90a``), bound with ctypes."""
