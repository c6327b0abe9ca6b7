"""Model definitions for the port (rwkv4)."""
