"""The multi-device engine on ``torch.distributed`` and the paper's
MapReduce jobs on it, resident and streamed (SPMD: every rank calls the same
entry points with its own row block or the same chunk stream)."""
