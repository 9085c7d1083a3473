"""Micro-benchmarks of the card that the kernels' estimates rest on."""
