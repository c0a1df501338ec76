"""Runners: one module a way of driving the program's timed path.  A
traffic file names its runner; ``run(ctx)`` returns the run's record."""
