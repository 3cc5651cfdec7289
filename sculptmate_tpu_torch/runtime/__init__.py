"""Device selection, kernel builds and checkpoint bridging."""
