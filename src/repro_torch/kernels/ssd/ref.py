"""Plain PyTorch versions: the chunked dual form (the kernel's algorithm,
any sequence length) and the sequential recurrence."""
from repro_torch.models.ssm import ssd_chunked, ssd_ref  # noqa: F401
