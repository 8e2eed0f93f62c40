"""Host-side runtime pieces the port's serving stack needs: the metrics
registry and the tracer ring.  The graph runtime itself (calculators,
streams, the executor) comes with the GraphServer slice (ROADMAP Queue 1
item 3b)."""
