"""repro_torch.checkpoint — snapshot directories on disk (the port of
``repro.checkpoint``)."""
