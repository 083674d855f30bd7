"""repro_torch.dist — distribution of the snapshot path.  Only the
single-device planning of ``repro.dist.insitu`` is ported so far; the rest
of ``repro.dist`` waits for the port's dist slice (ROADMAP Queue 1 item 10)."""
