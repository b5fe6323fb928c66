"""Losses, distances, batch selection and the CUDA kernels."""
