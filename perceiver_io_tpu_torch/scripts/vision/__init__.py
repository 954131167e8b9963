"""CLI entry points of the vision families."""
