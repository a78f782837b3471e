"""Multi-GPU rendering over torch.distributed (counterpart of `multichip/`):
row and sample tiles (`tiles`), the (slice, rows, samples) mesh
(`multislice`), process-group bring-up and the local launcher
(`distributed`), and texture placement (`memory`)."""
from . import memory, tiles  # noqa: F401
