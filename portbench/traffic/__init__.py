"""Traffic drivers, one file each, named by a cell's ``traffic`` key.
Each reads its parameters from the cell's ``params`` and has
``run(ctx) -> harness.Outcome``."""
