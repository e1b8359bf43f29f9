"""hinge_tpu_torch — the HINGE assembler on PyTorch and CUDA.

The same pipeline as `hinge_tpu` (filter -> maximal -> layout -> clip ->
draft-path -> draft -> map -> consensus -> gfa) with its device work as
torch ops and its two band-NW kernels written by hand in CUDA C++ for
Hopper (`csrc/`).  The package stands alone: the jax-free layers it
shares with `hinge_tpu` (config, data, io, native, graph, mapper,
clip/draft-path/gfa/draft stages) are copies kept here under the same
relative names, each naming its source; it imports neither jax nor
hinge_tpu.

Every device op takes an explicit device, threaded down from
`pipeline.assemble(..., device="cuda")` or a `cli` verb's --device.  The
CPU runs only when a caller passes device="cpu"; asking for CUDA without a
card raises `device.DeviceError`.  `cli` has every `hinge` verb of
hinge_tpu's CLI, and `hinge` is bin/hinge's verb table over them.
"""
