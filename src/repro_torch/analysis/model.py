"""Critical-point type codes of crossing nodes (classify.py)."""
from __future__ import annotations

CP_TYPES = ("saddle", "source", "sink", "spiral_in", "spiral_out",
            "center", "degenerate")
CP_CODE = {name: i for i, name in enumerate(CP_TYPES)}
