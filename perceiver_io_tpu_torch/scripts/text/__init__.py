"""CLI entry points of the text families."""
