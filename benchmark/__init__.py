"""The benchmark of the PyTorch and CUDA port (`hinge_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once.  Everything here but run.py's calls
into the port is frozen: the traffic generator (`traffic/`), the plain
reference that decides `correct` (`reference/`), the roofline counts
(`roofline.py`) and the per-layer metric readers (`metrics/`).
"""
