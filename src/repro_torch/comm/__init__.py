from repro_torch.comm.base import CommStats, Communicator
from repro_torch.comm.local import LocalComm

__all__ = ["CommStats", "Communicator", "LocalComm"]
