"""Training substrate of the port: AdamW, train step, checkpointing, data."""
