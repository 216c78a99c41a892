"""Kernels of the port: hand-written CUDA for Hopper plus plain versions."""
