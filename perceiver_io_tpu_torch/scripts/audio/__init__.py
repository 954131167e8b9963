"""CLI entry points of the audio families."""
