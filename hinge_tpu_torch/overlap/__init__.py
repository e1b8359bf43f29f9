"""The built-in all-vs-all overlapper: the device join of hinge_tpu as
torch ops (`device_join`) and its driver (`mapper.overlap_reads`)."""
