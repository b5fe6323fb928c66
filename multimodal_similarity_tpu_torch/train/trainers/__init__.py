"""Trainer entry points (``python -m ...trainers.<name>``)."""
