"""Training runtime of the port: the optimizer (AdamW with the bf16
first-moment and factored second-moment options), the deterministic data
stream (a byte-identical copy of the reference's), atomic checkpoints in
the reference's on-disk format, and the auto-resuming train loop."""
