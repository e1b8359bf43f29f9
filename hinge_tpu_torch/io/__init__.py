from hinge_tpu_torch.io.las import read_las, write_las  # noqa: F401
from hinge_tpu_torch.io.fasta import read_fasta, write_fasta  # noqa: F401
from hinge_tpu_torch.io.paf import read_paf  # noqa: F401
from hinge_tpu_torch.io.qv import read_db_qvs, read_quiva_qvs  # noqa: F401
