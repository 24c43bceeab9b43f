"""Training data: the seekable synthetic token stream."""
