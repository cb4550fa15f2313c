"""Mini classifier: the path universe the ladder lint checks."""

ENGINE_PATHS = ("linear", "exact_tree", "sampled")
