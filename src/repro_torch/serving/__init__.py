"""Serving engine, KV allocator, serving loop and metrics of the port."""
