"""Serving scenario: continuous batching with RowClone-backed paged KV.

Eight requests; the second four share the first request's prompt prefix
(think: same system prompt).  Prefix pages are shared (refcounted), the
divergent tails are copy-on-write RowClone page copies, freed pages are
zeroed in-memory (pim_init).  The JAX package's shim, with the same
arguments, over :func:`repro_torch.launch.serve.main`: it serves on the
card unless more arguments say otherwise (``--device cpu``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_rowclone
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from repro_torch.launch.serve import main as serve_main

ARGV = ["--arch", "granite-3-8b", "--requests", "8", "--prompt-len", "24",
        "--max-new", "8", "--share-prefix", "--page-size", "8"]


def main(argv: Optional[List[str]] = None) -> Dict:
    """Serve the scenario; ``argv`` (default: the command line's) is
    appended to its arguments.  Returns the printed summary."""
    return serve_main(ARGV + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
