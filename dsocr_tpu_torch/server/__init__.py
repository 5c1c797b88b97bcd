"""Request scheduling over the slot runtime."""
