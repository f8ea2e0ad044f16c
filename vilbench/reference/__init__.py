"""The plain reference: a frozen copy of the port's estimator (``vil``),
the two paths the benchmark times on it (``pipeline``), and the
comparison that decides ``correct`` (``compare``). Nothing here imports
the port."""
