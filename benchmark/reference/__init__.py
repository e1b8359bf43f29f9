"""The plain reference that decides `correct`: NumPy only, importing
neither jax, hinge_tpu nor hinge_tpu_torch.  It judges what an
assembly says by what the simulator knows of the genome and reads."""
