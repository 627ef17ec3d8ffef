"""Launch layer of the port: the LM train / prefill / decode steps, the
drivers, the mesh, the partition specs and the dry-run estimator."""
