"""Plain PyTorch reference of the served ensembles (imports nothing of the
program under test)."""
