"""User-facing generator facades."""
