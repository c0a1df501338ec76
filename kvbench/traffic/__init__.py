"""Traffic generators.  A traffic file ``kvbench/traffic/<mix>.json`` names
its generator (a module here) and gives its parameters; generators draw
everything from the run's seed."""
