"""The multi-device engine on ``torch.distributed`` and the paper's
MapReduce jobs on it (SPMD: every rank calls the same entry points with its
own row block)."""
