"""Membership-event helpers: the port's copy of ``leave_ids`` from
``repro/fleet/events.py``."""
from __future__ import annotations

import numpy as np


def leave_ids(value) -> list:
    """Normalize one ``leave_events`` value — a single satellite id or a
    sequence of them — into a list of ints."""
    if isinstance(value, (int, np.integer)):
        return [int(value)]
    return [int(v) for v in value]
