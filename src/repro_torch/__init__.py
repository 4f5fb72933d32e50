"""PyTorch + CUDA port of the AQPIM reproduction for one NVIDIA H100.

`repro` (the JAX package beside this one) is the reference; this package
mirrors its layout and module names and imports neither `jax` nor `repro`.
Entry points run on the card unless the caller asks for the CPU.
"""
