"""Pattern datasets of the associative-memory benchmark (``data.patterns``)."""
