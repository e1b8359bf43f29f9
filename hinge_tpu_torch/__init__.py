"""hinge_tpu_torch — the HINGE assembler on PyTorch and CUDA.

The same pipeline as `hinge_tpu` (filter -> maximal -> layout -> clip ->
draft-path -> draft -> map -> consensus -> gfa) with its device work as
torch ops and its two band-NW kernels written by hand in CUDA C++ for
Hopper (`csrc/`).  The JAX-free layers of `hinge_tpu` (config, data, io,
native, graph, mapper, clip/draft-path/gfa/draft stages) are imported, not
copied; this package never imports jax.

Every device op takes an explicit device, threaded down from
`pipeline.assemble(..., device="cuda")`.  The CPU runs only when a caller
passes device="cpu"; asking for CUDA without a card raises.
"""
