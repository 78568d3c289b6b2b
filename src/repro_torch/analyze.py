"""``python -m repro_torch.analyze`` — entry point shim for the analysis CLI.

The implementation lives in :mod:`repro_torch.core.analysis.cli`; this module
only exists so the tool is reachable at the short, documented module path.
"""
from .core.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
