"""Event-log loading for the analyze pipeline.

Thin wrapper over :class:`repro_torch.core.events.EventLog` JSONL I/O that adds
the validation policy analyzers want: by default a malformed file raises
with the full problem list instead of silently producing garbage stats.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.events import EventLog, validate_events


class InvalidEventLog(ValueError):
    """The file parsed but failed schema validation."""

    def __init__(self, path: str, problems: List[str]):
        self.problems = problems
        shown = "\n  ".join(problems[:20])
        more = f"\n  ... and {len(problems) - 20} more" \
            if len(problems) > 20 else ""
        super().__init__(
            f"{path}: {len(problems)} schema problem(s):\n  {shown}{more}")


def read_events(path: str, *, validate: bool = True) -> EventLog:
    """Load an ``events.jsonl`` file (header + events).

    With ``validate`` (default) the stream is schema-checked — unknown
    kinds, missing/ill-typed fields, bad tier names, or time going
    backwards raise :class:`InvalidEventLog`.
    """
    log = EventLog.read_jsonl(path)
    if validate:
        problems = validate_events(log.events)
        if problems:
            raise InvalidEventLog(path, problems)
    return log
