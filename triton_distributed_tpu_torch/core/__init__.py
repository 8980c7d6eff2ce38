"""Device selection, kernel build and shared helpers."""
