"""The benchmark's shared code: loading the data files, drawing the
weights and inputs from the seed, driving the port's serving pool through
a traffic loop, reading the trace, and the yardstick (work counts, peaks,
percentiles).  Nothing here imports the JAX package or JAX."""
