"""Plain references, one per configuration's ``reference`` key."""
