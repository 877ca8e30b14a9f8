"""Built-in checkers.  Importing this package registers all of them
(each module calls :func:`repro_torch.lint.core.register_checker` when it
is imported); ``repro_torch.lint.core`` imports it before every run."""
from repro_torch.lint.checkers import (batching, dtypes, imports, kernels,
                                       protocol, resilience, serve, steps)

__all__ = ["batching", "dtypes", "imports", "kernels", "protocol",
           "resilience", "serve", "steps"]
