"""Metric readers: ``<name>.py`` (or ``<family>.py`` for ``<family>.<part>``)
holds ``read(ctx) -> float | None``; None leaves the metric out of the line."""
