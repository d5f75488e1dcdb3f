"""Per-layer metric readers: ``metrics/<name>.py`` reads metric ``<name>``."""
