"""Step builders and the training driver (port of ``repro.launch``,
single device)."""
