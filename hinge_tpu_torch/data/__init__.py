from hinge_tpu_torch.data.overlaps import OverlapStore, ReadStore  # noqa: F401
