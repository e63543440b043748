from repro_torch.comm.base import CommStats, Communicator
from repro_torch.comm.collective import CollectiveComm, spmd_global_aggregate
from repro_torch.comm.local import LocalComm

__all__ = ["CollectiveComm", "CommStats", "Communicator", "LocalComm",
           "spmd_global_aggregate"]
