"""Traffic drivers, one module per kind of unit; a cell names its driver."""
