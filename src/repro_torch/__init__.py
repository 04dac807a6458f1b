"""PyTorch and CUDA port of the heterogeneous-ensemble inference system.

Mirrors the layout of the JAX package ``repro``; imports ``torch`` and never
JAX.  Entry points run on the CUDA card unless the caller asks for the CPU."""
