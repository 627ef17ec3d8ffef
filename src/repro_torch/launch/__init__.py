"""Launch layer of the port: the LM prefill / decode steps and the serving
driver."""
