"""repro_torch.data — the seeded synthetic datasets (numpy copies of
``repro.data``)."""
