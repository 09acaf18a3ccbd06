"""The distributed path on ``torch.distributed``: the process group and
mesh (``multihost``), the edge-sharded solve and the row-sharded top-k
(``sharded``), and the multi-rank dry run (``dryrun``)."""
from . import multihost, sharded

__all__ = ["multihost", "sharded"]
