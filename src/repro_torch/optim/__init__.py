"""repro_torch.optim — AdamW with its schedule and clipping, and the §7
gradient compression with error feedback (the port of ``repro.optim``)."""
