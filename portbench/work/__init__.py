"""Work counts for the roofline shares: one module per configuration
(``work/<config with - as _>.py``), each with ``per_iteration(shapes)``
returning the bytes, matrix-product operations and other operations
that one iteration of the algorithm needs at those shapes.  They take
shapes only, so they read the same whatever implements the iteration."""
