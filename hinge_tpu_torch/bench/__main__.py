"""`python -m hinge_tpu_torch.bench`: the bench.py twin (`bench.main`)."""

from hinge_tpu_torch.bench.bench import main

if __name__ == "__main__":
    main()
