"""Mini serving wrappers: the path-label site."""

_path_counts = {"exact": 0.0, "sampled": 0.0}


def record_explain_path(path, n=1):
    _path_counts[path] = _path_counts.get(path, 0.0) + n


class Model:
    def resolve(self, decision):
        self.explain_path = "sampled"
        if decision == "exact_tree":
            self.explain_path = "exact"
