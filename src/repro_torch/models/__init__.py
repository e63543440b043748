"""The LM of the port (``repro/models``): dense-family layers, GQA
attention, the decoder stack and the serving entry points."""
from repro_torch.models import attention, layers, lm, transformer

__all__ = ["attention", "layers", "lm", "transformer"]
