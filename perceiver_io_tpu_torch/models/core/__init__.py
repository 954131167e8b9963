"""Core Perceiver modules."""
