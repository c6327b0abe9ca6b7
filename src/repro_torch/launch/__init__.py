"""Command-line entry points for the port."""
